#!/usr/bin/env python3
"""Drive the PyTorch port (``dfq_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``dfq_tpu_torch/csrc`` (build time, and
   ptxas's registers / shared memory / spills for every kernel);
3. hold every kernel against its plain PyTorch version on the card, at
   every call site of the main path (MobileNetV2 at 224x224, batch 8),
   on random int8 inputs from a seeded ``torch.Generator``: int8 and f32
   outputs must be bit-equal. All are held again at an odd batch (3: no M
   is a multiple of a tile, K3 takes its small-batch plans) and, at their
   largest sites, at batch 128 (many tiles per persistent block; K3's
   largest and widest blocks under their tall-slab plans). ptxas must
   report no spills in any kernel;
4. the main path: full-width MobileNetV2 with random weights
   (``init_params(seed=0, bn_stats="random")``), the flagship DFQ config
   (``prepare``), ``lower_int8`` and ``Int8FusedNet`` on the card, batch 8
   at 224x224: the launch counts must read 11 / 5 / 12 per forward, every
   K1 and K3 launch must have taken the tensor-core variant, the stride-1
   K2 launch the strip variant and the four stride-2 ones (the stride-2
   depthwise convs) the stride-2 strip variant, and the logits must equal (atol 1e-4, same argmax)
   the same network run with the plain versions on the card;
5. serving, as a correctness check: 16 single-image requests through
   ``MicroBatcher`` over two batch buckets, each answer equal to its row
   of a direct batch forward (no latency is measured: 16 requests of
   made-up traffic say nothing of it);
6. times (CUDA events, median of several runs after warm-up): each kernel
   at its main-path shapes at batch 8 and 128 beside its bound, its plain
   version and a library yardstick (``torch._int_mm`` takes only
   M > 16 and K, N multiples of 8: a K1 site outside that has none, and
   the script says so), with the per-site table of all three; K3 also
   against a model of its own design's time that splits its work by the
   unit that does it (GEMMs at the tensor cores' peak, the depthwise row
   sums at a recorded dp4a rate; per site only, not a bound); the forward
   at batch 8 and 128.

7. the golden artifact (``golden/``) through the port's ``load_artifact``:
   the baseline engine (``Int8Net``) on ``golden/input.npy`` equals
   ``golden/logits.npy`` to 1e-5 with equal argmax (the JAX suite's
   limit), the fused engine gives the same argmax;
8. ResNet-18, full width, 224x224, batch 8, random weights from the seed,
   the flagship config: ``Int8FusedNet`` launches K1 once per forward (the
   ``fc``) and K2/K3 never, and its logits equal the plain-kernel net's
   (atol 1e-4, same argmax); the baseline engine agrees with it as the JAX
   suite holds the two (fused top-1 inside the baseline's top 5 for every
   image, argmax agreement >= 0.75); the f32 simulator on the card agrees
   with the same function on the CPU (the float model to ``SIM_RTOL`` of
   the largest logit, which TF32 or an inexact conv algorithm would break;
   with the fake-quant sites to ``SIM_FQ_RTOL``, the CPU test's limit);
9. every conv that has no kernel, at every call site of the four models,
   at two batches (8 and 3; DeepLab 4 and 3) and, at each model's largest
   sites, a larger one (128; DeepLab 8), through the packed product each
   engine holds (``products``), against ``F.conv2d`` in float64 on the
   card (exact: every sum is below 2^53), and the baseline engine's
   linear layers against a float64 product: the int32 accumulators must
   be bit-equal;
10. the classification entry point in-process (``run_cls --resnet
   --quantize --relu --equalize``), once with ``--engine fused`` and once
   with ``--engine int8``, each saving its artifact: the artifact reloaded
   through the same engine reproduces the entry point's logits bit for
   bit;
11. times (CUDA events, medians): ResNet-18's forward at batch 8 and 128
   through the fused engine, the baseline engine and the simulator; K1 at
   ResNet-18's ``fc`` beside its bound and ``torch._int_mm``; MobileNetV2's
   three engines at batch 128; SSD-Lite's fused forward at batch 1, 8 and
   128, its baseline and simulator at 8, ``decode_nms_batch`` at 1 and
   128; DeepLab's fused forward at batch 4 and 8, its baseline and
   simulator at 4; the peak device memory of each of these forwards; every
   kernel at every SSD-Lite site (batch 8 and 128) and DeepLab site
   (batch 4; its classifier also at 8 and 128) beside its bound, its plain
   version and a yardstick (``torch._int_mm`` on the packed weight, N
   zero-padded to a multiple of 8, and M <= 16 padded past 16 with zp
   rows); and a line a K1 site whose shape only the ``dp4a`` variant
   took before the tensor-core variants took N not a multiple of 8 and
   long K (``former_dp4a``: the class heads at b8 and b128, the
   classifier at b4 and b8): its device ms beside the ``dp4a`` variant's
   on the same rows (the same outputs), the bound and padded
   ``torch._int_mm``;
12. SSD-Lite 300x300 (21 classes, 3000 priors), random weights from the
   seed, the flagship config with the detection flags: 30 / 19 / 12
   kernel sites, K1 at all 30 through its resident ``mma`` variant (the 6
   class heads, N = 126, on weights padded to 128), K2 ``strip`` and, at
   the 8 stride-2 depthwise convs, ``strip_s2``, K3 ``mma``; every kernel equal to its plain version at every site at batch
   8 and 3 and, at each kernel's largest sites and every class head, 128;
   the batch-8 forward bit-equal to the plain-kernel net, no plain version run through
   a wrapper; the baseline engine on the card equal to itself on the CPU
   within ``ENGINE_RTOL`` of the largest output, confidences summing to 1;
   the fused and baseline engines within the JAX suite's mean bounds of
   each other; ``decode_nms_batch`` on the card keeping the same boxes in
   the same order as the host NMS on the same outputs; ``run_ssd --engine
   fused --device-nms`` and ``--engine int8 --save-artifact`` in-process,
   the reloaded artifact bit-equal;
13. DeepLab-v3+ MobileNetV2 513x513 (output stride 16, 21 classes), batch
   4, the same weights and config: 38 K1 sites (all ``mma``, the
   classifier's N = 21 padded to 24), K2 and K3 never; every site equal
   to its plain version at batch 4 and 3 (the classifier also at 8 and
   128); the forward
   bit-equal to the plain-kernel net, the per-pixel argmax taken on the
   card; the baseline engine on the card against the CPU as in 12, the
   two engines' argmax agreeing as the JAX suite holds it; ``run_seg
   --engine fused`` and ``--engine int8 --save-artifact`` in-process, the
   reloaded artifact bit-equal;
13a. the glue convs' epilogue kernel (``csrc/conv_epilogue_int8.cu``, glue
   and no K-site: its own counter ``EPILOGUE_LAUNCHES``, apart from
   ``LAUNCHES``) at every glue conv site of the four paths, on the
   accumulator the site's own product leaves from a random int8 input:
   bit-equal to its plain version at the path's batch, at 3 and at its
   benchmark cell's batch (MobileNetV2, ResNet-18, SSD-Lite 128, DeepLab
   32), where each site is timed (host calls, CUDA-graph replays, the
   plain version) beside its byte bound; the wrapper's host cost a call
   against a bare launch. Around every fused forward of every phase whose
   launches are counted (run step by step, ``step_by_step``, or in a
   sharded path the trace of a call that only replays,
   ``replayed_kernels``) the epilogue launches once a glue ``conv`` step
   of the net's lowering and never under ``plain_kernels`` or
   ``use_kernels=False``, with no plain run through its wrapper; the main
   paths pin that at 1 / 20 / 1 / 23
   (MobileNetV2, also calibrated, AOT and a shard; ResNet-18; SSD-Lite;
   DeepLab, also a shard) (``EPILOGUE_PINS``).

14. calibration (``--distill_range``), MobileNetV2 224x224 with the
   flagship config: ``distill_batch_fn`` at run_cls's batch (64) capped at
   ``DIS_STEPS`` steps in f32 and in bf16 (ms per step between CUDA events,
   peak device memory; bf16's last loss within 25% of f32's); the f32 loss
   and gradient at the seed batch on the card equal to the CPU's within
   ``DIS_LOSS_RTOL`` and ``DIS_GRAD_RTOL`` (and what TF32 in the backward
   would give, printed beside them); ``calibrate_ranges`` on the
   two distilled batches, on the card against the CPU: at least 90% of the
   sites within one fake-quant step, every one within 2% of its span (the
   self-quant forwards flip ties); ``lower_int8`` and ``Int8FusedNet`` under those
   ranges: 11 / 5 / 12 launches, K1 and K3 ``mma``, K2 ``strip`` and
   ``strip_s2``, the
   forward bit-equal to the plain-kernel net, every kernel bit-equal to its
   plain version at every site at batch 8 and 3; ``run_cls --distill_range
   --engine fused --dis_batch_size 16 --dis_num_batch 1`` in-process with
   its own 1000-step budget (wall time); the distillation step at SSD-Lite
   300x300 and DeepLab 513x513, batch 16, bf16 (ms per step, peak memory).

15. the native deployment path: ``libdfqrt`` (``native/src/dfqrt.cpp``, the
   host runtime) built by the port with g++ (build seconds); ``python -m
   dfq_tpu_torch.cli.convert --relu --equalize --validate`` in-process
   (MobileNetV2 224x224, full width, the seed's weights, the ncnn regime);
   the golden artifact's and convert's native files re-exported from their
   artifact directories byte-identical to the files beside them; the
   runtime on ``golden/input.npy`` within 1e-4 of ``golden/logits.npy``,
   same argmax; the runtime on the host against ``Int8Net`` on the card at
   2 images under ``tests/test_native_runtime.py:62-67``'s contract (mean
   |diff| < 2e-3, max < 5e-2, > 90% within 5e-3, equal top-1); the
   runtime's ms per image at batch 1 and 8 with its OpenMP threads and
   the host CPU's model;
16. the AOT cold start: ``run_cls --quantize --relu --equalize --engine
   fused --save-artifact D --aot-batch 128`` in-process; a fresh Python
   process whose ``nvcc`` is unreachable and whose build directory is
   empty loads ``load_aot_forward(D)`` and runs batch 128: its logits
   bit-equal to the exporting process's, 11 / 5 / 12 launches, nothing
   built; the same from a fresh process that builds the kernels with
   ``nvcc`` into an empty directory; both processes' seconds from start
   to first logits and the payload's bytes; a ``meta.json`` with another
   card's name refused with ``ValueError``;
17. the rest of the model zoo, full width, random weights from the seed:
   DeepLab-v3+ Xception, DRN-D-54 and ResNet-101 at 513x513 batch 4 (the
   flagship config), the SSD variants MobileNetV1-SSD, -SSD-Lite,
   SqueezeNet-SSD-Lite, FPN-MobileNetV1-SSD and VGG16-SSD at 300x300
   batch 8, and AlexNet at 224x224 batch 8 (``--relu --equalize`` with
   ranges calibrated on the card over two seeded batches: the data-free
   range setter refuses BN-less graphs, as the reference does). For each:
   the kernel sites and launches equal to the JAX fused engine's
   ``pallas_call`` counts (``ZOO``) and K2 at the graph's stride-2
   depthwise convs (:func:`stride2_dw_sites`), every site bit-equal to its plain
   version at the model's batch and at batch 3, the forward bit-equal to
   the plain-kernel net with outputs of the expected shapes, the baseline
   engine on the card against the CPU within ``ENGINE_RTOL`` (DeepLab at
   1 image, the others at 2), phase 9's float64 check of every other int8
   product at batch 2, the fused forward's median ms and peak memory,
   every kernel site's time beside its bound, plain version and yardstick,
   and each former ``dp4a`` site (the K = 2048 convs of the DeepLab
   backbones at b4 and b8, the SSD variants' class heads and AlexNet's
   classifier at b8 and b128) as in 11. No forward of any phase launches
   K1's ``dp4a`` variant (``k1_on_tensor_cores``);
18. ``dfq_tpu_torch.parallel`` at full width on the one card (a mesh may
   name a device more than once): MobileNetV2 224x224 at b128 through
   ``make_sharded_forward`` and ``make_sharded_eval`` (fused engine) on
   ``data_mesh()`` and on 4 and 3 shards of the card (b32; 43 / 43 / 42):
   the logits bit-equal to the single forward (a new replica's first
   call and a call that only replays its graph), the counters equal,
   11 / 5 / 12 kernel calls a shard in the trace of the replaying call,
   every kernel site bit-equal to its plain version
   at b32 and b42, the forward's ms beside the single forward's at the
   global and the shard batches; 6 host batches of b128 through
   ``make_streaming_eval`` (depth 2) and the synchronous loop (counters
   equal, ms a batch) and the host syncs of the fused forward and of a
   stream, as ``torch.cuda.set_sync_debug_mode("warn")`` reports them;
   DeepLab 513x513 b4 on 2 shards (``make_sharded_seg_eval``: the
   confusion matrix equal to ``SegEvaluator``'s on the single forward, on
   the first call and on a traced call that only replays, whose trace
   shows 38 K1 calls a shard);
   the distillation step at b64 (f32) on 4 shards against the
   single-device step (loss within ``PAR_LOSS_RTOL``, gradient within
   ``DIS_GRAD_RTOL`` of its max, both read from the steps' own Adam
   states, the stepped images within ``PAR_X1_RTOL`` of their max at
   every pixel whose gradient is above ``PAR_X1_G_FLOOR``, with the pixels
   outside that limit counted, ms a step); ``make_tp_int8_forward`` on a
   2x2 mesh at b8 against ``Int8Net`` (within ``TOL`` of the largest
   logit, equal argmax); a one-process NCCL group (``multihost.initialize``): the
   ``all_reduce`` sum and counters of ``make_global_batch`` equal to the
   local ones; ``multibox_loss`` at SSD-Lite's 3000 priors, b32 x 21
   classes, on the card against the CPU (equal masks, within
   ``MULTIBOX_RTOL``).

19. the fused engine's lowering policies (``Int8FusedNet``'s options, the
   JAX engine's): ``stem_s2d``, dense-diagonal depthwise (32 channels, 160
   rows), ``chpad_k3``, ``k3_matmul`` im2col and shift9 for every dense
   3x3 conv, ``b2s_min_h=56``, ``fuse_blocks=False``, ``use_kernels=False``
   and both, on MobileNetV2 224x224 at b8 and b128, ResNet-18 at b128,
   SSD-Lite at b8 and DeepLab at b4: the launches per kernel equal to the
   JAX fused engine's ``pallas_call`` counts under the same options
   (``POLICY_LAUNCHES``); each conv policy's outputs bit-equal to the
   default net's; each kernel configuration's bit-equal to the same
   configuration on the kernels' plain versions and, on 1-2 images, within
   ``ENGINE_RTOL`` of itself on the CPU (its K1/K2 and K3 round a tie of
   the output scale's reciprocal apart, as JAX's do, so it may part from
   the default: printed); every kernel site the default net does not have
   bit-equal to its plain version; the forward's median ms and peak device
   memory beside the default's (read before and after);
   ``autotune_dw_policy`` on MobileNetV2 and SSD-Lite at b8
   (each candidate's time and spread, a cache hit, a truncated cache
   raced again); ``roofline_report`` of MobileNetV2 b128 with the card's
   peaks beside the measured default forward.

20. the fused forward as a CUDA graph: on MobileNetV2, ResNet-18, SSD-Lite
   and DeepLab at their benchmark cells' batches (b128, DeepLab b32), a
   new net's first forward runs step by step and its second captures the
   graph: every replayed forward bit-equal to the step-by-step forward on
   the same images, a result untouched by a later call on other images,
   ``GRAPH_COUNTS`` moved by one capture and the replays, the first
   forward's launches (by kernel, and the epilogue's) one a site of the
   lowering, and in a ``torch.profiler`` trace of a replayed forward each
   kernel's device calls (the epilogue's too, named as the benchmark's
   trace names them) one a site as well; the ms a forward back to back and the
   host ms a forward, step by step and replayed, and the device memory
   the caching allocator reserves before and after the capture.

Phases 12, 13 and 13a run after 10 and before 11, and 14 to 20 after 11. It
prints the ``kernels`` JSON line (with each kernel's launches on each
model's path: the calibrated, the AOT, the zoo's and the sharded
included; the epilogue's row last), then the card line, then as the last line ``{"ok": true,
"device": {...}}``.
Per-site details go to ``chiprun_out/chip_smoke.json``. Without CUDA it
exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

DEVICE = "cuda"
BATCH = 8  # the main path's batch
BIG_BATCH = 128  # the timing batch beside it
ODD_BATCH = 3  # phase 3: no site's M is a multiple of a tile
SIZE = 224
TOL = 1e-4  # logits, as the CPU slice test (tests/test_int8_fused.py:102)
GOLDEN_TOL = 1e-5  # tests/test_golden_artifact.py:37
# simulator on the card vs on the CPU, as a share of the largest logit: the
# float model (f32 sums in other orders: ~1e-6; TF32 keeps ~1e-3 a conv),
# and with its fake-quant sites (a tie flipped by a last-bit difference
# moves a value a grid step: tests/test_torch_executor.py's limit)
SIM_RTOL = 1e-4
SIM_FQ_RTOL = 2e-2
# the baseline engine on the card vs on the CPU, as a share of the largest
# output: its int8 products are exact and its f32 glue sums in the same
# order, but a resize's matmul may sum its taps in another order
ENGINE_RTOL = 1e-5
SSD_SIZE = 300
SEG_SIZE = 513
SEG_BATCH = 4  # the segmentation path's batch (the CLI's --batch-size)
DET = {"delete_single": True, "is_detection": True}  # run_ssd's QuantConfig flags
# the glue conv steps of each path's fused forward, one launch each of the
# glue convs' epilogue kernel (ops/conv_epilogue.py), and the benchmark
# cell's batch at which phase 13a times each such site
EPILOGUE_PINS = {"mobilenet_v2": 1, "resnet18": 20, "ssd_lite": 1, "deeplab_mnv2": 23}
EPILOGUE_CELL_BATCH = {"mobilenet_v2": 128, "resnet18": 128, "ssd_lite": 128,
                       "deeplab_mnv2": 32}
# the epilogue's launches read around each path's forward, by path
EPILOGUE_SEEN: dict = {}
# phase 14: run_cls's distillation batch, the capped step counts it is timed
# over, the detection and segmentation CLIs' batch, and the limits between
# the distillation loss and gradient on the card and on the CPU. The loss
# takes the CPU test's (tests/test_torch_calib.py); the gradient, of its
# largest magnitude, 1e-4: the CPU test's 1e-5 holds on its small CNN (on
# the card too, tests/test_torch_cuda.py), but the backward through
# MobileNetV2's 52 convs sums in two orders and parts by 2.3e-5 (NVIDIA
# H100 80GB HBM3, two calls alike). The script prints what TF32 gives.
DIS_BATCH = 64
DIS_STEPS = 40
DIS_BATCH_SEG_DET = 16
DIS_STEPS_SEG_DET = 10
DIS_LOSS_RTOL = 1e-6
DIS_GRAD_RTOL = 1e-4

# dp4a instructions per second of one H100 SXM, lanes counted: 63 per clock
# and SM (dfq_tpu_torch/tools/pipe_rates.py measured 62-64 at 1,980 MHz on
# an NVIDIA H100 80GB HBM3 at 700 W) x 132 SMs; each does 4 int8 MACs, of
# which a 3x3 depthwise row sum uses 3. A recorded rate, below the pipe's
# nominal 64: it enters fused_block_split_bound_ms only, never bound_ms
DP4A_PER_S = 63 * 132 * 1.98e9


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def site_inputs(graph, batch: int, size: int):
    """NHWC shape of every node's output, by propagation from the input."""
    shapes = {}
    for node in graph:
        if node.op == "input":
            shapes[node.name] = (batch, size, size, 3)
            continue
        s = shapes[node.inputs[0]]
        a = node.attrs
        if node.op == "conv":
            (kh, kw), (sh, sw) = a["kernel"], a["stride"]
            (ph, pw), (dh, dw) = a["padding"], a["dilation"]
            shapes[node.name] = (
                s[0], (s[1] + 2 * ph - dh * (kh - 1) - 1) // sh + 1,
                (s[2] + 2 * pw - dw * (kw - 1) - 1) // sw + 1, a["out_ch"])
        elif node.op == "linear":
            shapes[node.name] = (s[0], a["out_f"])
        elif node.op == "global_mean":
            shapes[node.name] = (s[0], s[3])
        elif node.op in ("maxpool", "avgpool"):
            (kh, kw), (sh, sw), (ph, pw) = a["window"], a["stride"], a["padding"]
            shapes[node.name] = (s[0], (s[1] + 2 * ph - kh) // sh + 1,
                                 (s[2] + 2 * pw - kw) // sw + 1, s[3])
        elif node.op == "pad":
            t, b, l, r = a["pads"]
            shapes[node.name] = (s[0], s[1] + t + b, s[2] + l + r, s[3])
        elif node.op == "global_pool":
            shapes[node.name] = (s[0], 1, 1, s[3])
        elif node.op == "interpolate":
            shapes[node.name] = (s[0], *a["size"], s[3])
        elif node.op == "concat" and a.get("axis", -1) in (-1, 3):
            shapes[node.name] = s[:-1] + (sum(shapes[i][-1] for i in node.inputs),)
        elif node.op == "reshape":  # shape excludes the batch; one -1
            rest = [d for d in a["shape"] if d != -1]
            n = int(np.prod(s[1:])) // int(np.prod(rest))
            shapes[node.name] = (s[0],) + tuple(n if d == -1 else d for d in a["shape"])
        else:
            shapes[node.name] = s
    return shapes


def time_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median over ``rounds`` of the mean time of ``reps`` back-to-back
    calls, between CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    return float(np.median(per))


def graph_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured into a CUDA graph
    and replayed, so the host's per-call cost (Python, ctypes, the
    allocator) is not in it, as it is in :func:`time_ms` wherever a call
    is shorter on the device than on the host. Median over ``rounds``."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(per))


def work(kernel: str, op, shape, out_bytes: int):
    """(bytes, int8 ops) the function must move and do: each input read
    once, each output written once. It counts the function's operands,
    not what a kernel reads in their place: K1's parameters are
    ``N * K + 12 * N`` bytes (w, scale, bias, wsum) and K2's ``17 * C``
    (9 taps, scale, bias) whatever padded or pre-multiplied copy
    (``zp_tapsum``) the kernel of the day loads, so the bound is the same
    yardstick before and after a redesign."""
    if kernel == "matmul_int8_requant":
        M, K = shape
        N = op.n_out  # not the packed weight's rows, padded to a multiple of 8
        return M * K + N * K + 12 * N + M * N * out_bytes, 2 * M * N * K
    if kernel == "dw3x3_int8_requant":
        N, H, W, C = shape
        s = op.stride
        n_out = N * -(-H // s) * -(-W // s) * C
        return N * H * W * C + 17 * C + n_out * out_bytes, 2 * 9 * n_out
    N, H, W, C = shape
    E, C2 = op.E, op.C2
    px = N * H * W
    wbytes = C * E + 9 * E + E * C2 + 20 * E + 12 * C2
    return px * C + wbytes + px * C2 * out_bytes, 2 * px * (C * E + 9 * E + E * C2)


def fused_block_split_bound_ms(op, shape, int8_peak: float) -> float:
    """A model of this design's time, not a bound of the function and not
    ``bound_ms``: the two GEMMs' operations at the int8 tensor-core peak
    plus the depthwise conv as this kernel does it, one dp4a per row of 3
    taps (3 per expanded value, where 9 MACs fill 2.25), at the dp4a rate
    that ``DP4A_PER_S`` records from an earlier run (this run does not
    measure it). It says how far the kernel is from its own units' rates;
    kernels are ranked against :func:`work`'s ``bound_ms``."""
    N, H, W, C = shape
    px = N * H * W
    gemm_ops = 2 * px * (C * op.E + op.E * op.C2)
    dw_dp4a = px * op.E * 3
    return (gemm_ops / int8_peak + dw_dp4a / DP4A_PER_S) * 1e3


# the shapes torch._int_mm takes on CUDA
INT_MM_RULE = "torch._int_mm needs M > 16 and K, N multiples of 8"
# the rows a K1 yardstick pads M <= 16 to (zp_in rows), past INT_MM_RULE's 16
INT_MM_MIN_M = 24


def library_call(kernel: str, op, x):
    """One PyTorch call computing the kernel's core, never used by the
    port: the int8 product for K1 (on the packed weight, whose columns are
    zero-padded to the next multiple of 8 where N is not one, and with M
    <= 16 padded to ``INT_MM_MIN_M`` rows of zp_in), the f32 depthwise MAC
    for K2. Returns ``(call, padded)``: ``padded`` says what was padded
    ("" for nothing); ``(None, "")`` where there is none (K3) or K is
    outside ``INT_MM_RULE``."""
    import torch
    import torch.nn.functional as F

    if kernel == "matmul_int8_requant":
        M, K = x.shape
        if K % 8:
            return None, ""
        padded = []
        if op.w.shape[0] != op.n_out:
            padded.append(f"N {op.n_out} -> {op.w.shape[0]}")
        if M <= 16:
            x = F.pad(x, (0, 0, 0, INT_MM_MIN_M - M), value=op.zp_in)
            padded.append(f"M {M} -> {INT_MM_MIN_M} (zp rows)")
        w_kn = op.w.t()  # column-major [K, Np], cuBLASLt's layout
        return (lambda: torch._int_mm(x, w_kn)), ", ".join(padded)
    if kernel == "dw3x3_int8_requant":
        C = x.shape[-1]
        xf = x.permute(0, 3, 1, 2).float().contiguous(memory_format=torch.channels_last)
        wf = op.taps.t().reshape(C, 1, 3, 3).float().contiguous()
        return (lambda: F.conv2d(xf, wf, stride=op.stride, padding=1, groups=C)), ""
    return None, ""


def ptxas_report(log: Path):
    """ptxas -v's figures for each kernel of one library's build log:
    ``[{kernel, registers, smem, spill_stores, spill_loads}]``."""
    import re

    out = []
    if not log.exists():
        return out
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            out.append({"kernel": m.group(1), "registers": None, "smem": 0,
                        "spill_stores": None, "spill_loads": None})
            continue
        if not out:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[-1]["spill_stores"], out[-1]["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem"] = int(sm.group(1)) if sm else 0
    return out


def flagship(graph_fn, **flags):
    """The flagship DFQ config (plus ``flags``) on a model with random
    weights from the seed: ``(prepared, lowered, residual f32 params)``."""
    from dfq_tpu_torch.engine import lower_int8
    from dfq_tpu_torch.models import init_params
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    graph = graph_fn()
    cfg = QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                      correction=True, bits_bias=16, **flags)
    prep = prepare(graph, init_params(graph, seed=0, bn_stats="random"), cfg)
    model = lower_int8(prep)
    return prep, model, {k: v for k, v in prep.params.items() if k not in model.layers}


def forward_ms(fn, x, rounds: int = 7) -> float:
    """Median over ``rounds`` of 5 synchronised forwards, as phase 6."""
    import torch

    with torch.no_grad():
        return float(np.median([time_ms(lambda: fn(x), reps=5, rounds=1)
                                for _ in range(rounds)]))


def site_input(graph, size: int, kernel: str, name: str, batch: int, gen):
    """Random int8 input of one kernel site at ``batch`` (K1: ``[M, K]``)."""
    import torch

    shape = site_inputs(graph, batch, size)[graph[name].inputs[0]]
    x = torch.randint(-128, 128, shape, generator=gen, device=DEVICE, dtype=torch.int8)
    return x.reshape(-1, shape[-1]) if kernel == "matmul_int8_requant" else x


def wrappers_of(ck) -> dict:
    """Each kernel's wrapper and plain version."""
    return {
        "matmul_int8_requant": (ck.matmul_int8_requant_packed, ck.matmul_int8_requant_plain),
        "dw3x3_int8_requant": (ck.dw3x3_int8_requant_packed, ck.dw3x3_int8_requant_plain),
        "fused_block_int8": (ck.fused_block_int8_packed, ck.fused_block_int8_plain),
    }


def hold_sites(graph, size: int, checks, wrappers, max_err: dict, gen) -> None:
    """Each ``((node, kernel, op), batch)`` of ``checks`` through the kernel
    and its plain version on the same random input: bit-equal, or raise.
    ``max_err`` keeps each kernel's largest difference."""
    import torch

    for (name, kernel, op), batch in checks:
        wrap, plain = wrappers[kernel]
        x = site_input(graph, size, kernel, name, batch, gen)
        got = wrap(x, op)
        torch.cuda.synchronize()
        want = plain(x, op)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or got.shape != want.shape:
            raise AssertionError(f"{kernel} at {name}: {got.dtype}{tuple(got.shape)} "
                                 f"vs plain {want.dtype}{tuple(want.shape)}")
        err = float((got.double() - want.double()).abs().max())
        max_err[kernel] = max(max_err[kernel], err)
        if not torch.equal(got, want):
            n_bad = int((got != want).sum())
            raise AssertionError(f"{kernel} at {name} {tuple(x.shape)}: {n_bad} elements "
                                 f"differ from the plain version (max abs {err})")
        del x, got, want


def time_site(kernel: str, op, x, wrappers, peaks, reps: int = 20, rounds: int = 5) -> dict:
    """One kernel site's times beside its bound, its plain version and its
    library yardstick."""
    wrap, plain = wrappers[kernel]
    mem_bw, int8_peak = peaks
    out = wrap(x, op)
    nbytes, nops = work(kernel, op, tuple(x.shape), out.element_size())
    lib, padded = library_call(kernel, op, x)
    bytes_ms, ops_ms = nbytes / mem_bw * 1e3, nops / int8_peak * 1e3
    return {"kernel": kernel, "shape": list(x.shape),
            "ms": time_ms(lambda: wrap(x, op), reps, rounds),
            "device_ms": graph_ms(lambda: wrap(x, op), reps, rounds),
            "plain_ms": time_ms(lambda: plain(x, op), reps=3, rounds=3),
            "library_ms": None if lib is None else time_ms(lib, reps, rounds),
            "library_device_ms": None if lib is None else graph_ms(lib, reps, rounds),
            "library_padded": padded, "bytes": nbytes, "ops": nops,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def print_sites(sites) -> None:
    print("per site: batch node shape | ms (host calls) | ms (device, graph replay) "
          "| bound ms (by) | library ms (host calls / device) | device ms / bound "
          "[| K3: split model ms (this design's units at their rates), device ms / it]")
    for s in sites:
        lib = ("none" if s["library_ms"] is None
               else f"{s['library_ms']:.4f} / {s['library_device_ms']:.4f}"
               + (f" (padded: {s['library_padded']})" if s["library_padded"] else ""))
        split = s.get("split_bound_ms")
        print(f"  b{s['batch']} {s['node']} {tuple(s['shape'])} | {s['ms']:.4f} | "
              f"{s['device_ms']:.4f} | {s['bound_ms']:.4f} ({s['bound_by']}) | {lib} | "
              f"{s['device_ms'] / s['bound_ms']:.1f}x"
              + ("" if split is None else f" | {split:.4f}, {s['device_ms'] / split:.1f}x"),
              flush=True)


def former_dp4a(ck, op) -> bool:
    """A K1 site whose shape only the dp4a variant took before the
    tensor-core variants took it: N not a multiple of 8, or a K whose
    128-row x tile does not fit shared memory (the streamed variant's)."""
    return op.n_out % 8 != 0 or ck.MM_TILE_M * ck.matmul_pitch(op.w.shape[1]) > ck.SMEM_BUDGET


def time_former_dp4a(ck, wrappers, peaks, path: str, batch: int, node: str, op, x,
                     reps: int = 10, rounds: int = 3) -> dict:
    """One former dp4a site: the kernel's device ms (graph replay) beside
    the dp4a variant's on the same rows, the "before" (x copied 4 bytes
    off its 16-byte boundary, which only that variant takes; its output
    must equal the kernel's), the bound and padded ``torch._int_mm``."""
    import torch

    wrap, _ = wrappers["matmul_int8_requant"]
    mem_bw, int8_peak = peaks
    ck.reset_counts()
    out = wrap(x, op)
    variant = next(v for v, n in ck.VARIANTS["matmul_int8_requant"].items() if n)
    buf = torch.empty(x.numel() + 16, dtype=torch.int8, device=x.device)
    x_off = buf[4:4 + x.numel()].view_as(x)
    x_off.copy_(x)
    ck.reset_counts()
    before = wrap(x_off, op)
    torch.cuda.synchronize()
    if x_off.data_ptr() % 16 != 4 or ck.VARIANTS["matmul_int8_requant"]["dp4a"] != 1:
        raise AssertionError(f"{path} {node}: the offset input did not take dp4a")
    if variant == "dp4a" or not torch.equal(out, before):
        raise AssertionError(f"{path} {node}: {variant} vs dp4a differ")
    nbytes, nops = work("matmul_int8_requant", op, tuple(x.shape), out.element_size())
    bytes_ms, ops_ms = nbytes / mem_bw * 1e3, nops / int8_peak * 1e3
    lib, padded = library_call("matmul_int8_requant", op, x)
    t = {"path": path, "batch": batch, "node": node, "shape": [*x.shape, op.n_out],
         "variant": variant,
         "device_ms": graph_ms(lambda: wrap(x, op), reps, rounds),
         "dp4a_device_ms": graph_ms(lambda: wrap(x_off, op), reps, rounds),
         "bound_ms": max(bytes_ms, ops_ms),
         "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
         "library_device_ms": None if lib is None else graph_ms(lib, reps, rounds),
         "library_padded": padded}
    lib_s = ("none" if lib is None else f"{t['library_device_ms']:.4f}"
             + (f" (padded: {padded})" if padded else ""))
    print(f"former dp4a site {path} b{batch} {node} (M, K, N) {tuple(t['shape'])}: {variant} "
          f"{t['device_ms']:.4f} device ms, dp4a "
          f"{t['dp4a_device_ms']:.4f} ({t['dp4a_device_ms'] / t['device_ms']:.1f}x), bound "
          f"{t['bound_ms']:.4f} ({t['bound_by']}; {t['device_ms'] / t['bound_ms']:.1f}x), "
          f"padded _int_mm {lib_s}", flush=True)
    del buf, x_off, out, before
    return t


def forward_peak(fn, x):
    """``(median ms, peak device bytes)`` of ``fn(x)``: ``forward_ms`` and
    ``max_memory_allocated`` over one more forward from a reset peak."""
    import torch

    ms = forward_ms(fn, x)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        fn(x)
    torch.cuda.synchronize()
    return ms, int(torch.cuda.max_memory_allocated())


def hold_engines_card_vs_cpu(label, model, residual, x, rtol: float) -> dict:
    """The baseline engine on the card against the same engine on the CPU
    on the same images, each output within ``rtol`` of its largest value."""
    import torch

    from dfq_tpu_torch.engine import Int8Net

    with torch.no_grad():
        card = Int8Net(model, residual, device=DEVICE)(x)
        cpu = Int8Net(model, residual, device="cpu")(x.cpu())
    card = card if isinstance(card, tuple) else (card,)
    cpu = cpu if isinstance(cpu, tuple) else (cpu,)
    out = []
    for a, b in zip(card, cpu):
        a, b = a.cpu().numpy(), b.numpy()
        d, peak = float(np.abs(a - b).max()), float(np.abs(b).max())
        out.append({"max_abs": d, "max_out": peak})
        if not np.isfinite(a).all() or d > rtol * peak:
            raise AssertionError(f"{label}: baseline engine card vs CPU max abs {d} > "
                                 f"{rtol} x {peak}")
    return {"outputs": out}


def phase_golden(root: Path) -> dict:
    """7. The committed golden artifact through both engines on the card."""
    import torch

    from dfq_tpu_torch.engine import Int8FusedNet, Int8Net
    from dfq_tpu_torch.io import load_artifact

    model, residual = load_artifact(str(root / "golden" / "artifact"))
    x = torch.from_numpy(np.load(root / "golden" / "input.npy")).to(DEVICE)
    want = np.load(root / "golden" / "logits.npy")
    with torch.no_grad():
        got = Int8Net(model, residual, device=DEVICE)(x).cpu().numpy()
        fused = Int8FusedNet(model, device=DEVICE, params_f32=residual)(x).cpu().numpy()
    diff = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
    if diff > GOLDEN_TOL or not (got.argmax(-1) == want.argmax(-1)).all():
        raise AssertionError(f"golden: baseline engine {got.shape} max abs {diff} vs "
                             f"golden/logits.npy, argmax {got.argmax(-1)} vs {want.argmax(-1)}")
    if not np.isfinite(fused).all() or not (fused.argmax(-1) == want.argmax(-1)).all():
        raise AssertionError(f"golden: fused engine argmax {fused.argmax(-1)} vs "
                             f"{want.argmax(-1)}")
    print(f"golden artifact: baseline engine max abs {diff} (limit {GOLDEN_TOL}), argmax "
          f"{got.argmax(-1).tolist()} == pinned; fused engine argmax equal", flush=True)
    return {"max_abs": diff, "fused_max_abs": float(np.abs(fused - want).max())}


def phase_resnet(ck, images) -> dict:
    """8. ResNet-18 at full width, 224x224, batch 8, through the fused
    engine (launch counts, against its plain-kernel net), the baseline
    engine and the simulator (on the card against the CPU)."""
    import torch

    from dfq_tpu_torch.engine import Int8FusedNet, Int8Net
    from dfq_tpu_torch.graph import execute
    from dfq_tpu_torch.graph.executor import params_to
    from dfq_tpu_torch.models import resnet18
    from dfq_tpu_torch.ops import conv_epilogue as cep

    prep, model, residual = flagship(resnet18)
    net = Int8FusedNet(model, device=DEVICE)
    ref_net = Int8FusedNet(model, device=DEVICE, plain_kernels=True)
    base = Int8Net(model, residual, device=DEVICE)
    if [(n, k) for n, k, _ in net.kernel_sites] != [("fc", "matmul_int8_requant")]:
        raise AssertionError(f"ResNet-18 kernel sites {net.kernel_sites}")
    x8 = torch.from_numpy(images[:BATCH]).to(DEVICE)
    with torch.no_grad():
        ck.reset_counts()
        cep.reset_counts()
        logits = step_by_step(net, x8)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        k1_on_tensor_cores("ResNet-18", ck.VARIANTS)
        epilogue_launches("resnet18", net, BATCH, pin="resnet18")
        cep.reset_counts()
        ref = ref_net(x8)
        torch.cuda.synchronize()
        epilogue_launches("resnet18 plain-kernel net", ref_net, BATCH)
        lg_base = base(x8).cpu().numpy()
    if launches != {"matmul_int8_requant": 1, "dw3x3_int8_requant": 0, "fused_block_int8": 0}:
        raise AssertionError(f"ResNet-18 launches {launches}")
    lg, rf = logits.cpu().numpy(), ref.cpu().numpy()
    if lg.shape != (BATCH, 1000) or not np.isfinite(lg).all():
        raise AssertionError(f"ResNet-18 logits {lg.shape}, finite={np.isfinite(lg).all()}")
    diff = float(np.abs(lg - rf).max())
    if diff > TOL or not (lg.argmax(-1) == rf.argmax(-1)).all():
        raise AssertionError(f"ResNet-18 logits vs plain versions: max abs {diff}")
    # the JAX suite's fused-vs-baseline check (tests/test_int8_fused.py:40-67)
    top5 = np.argsort(lg_base, -1)[:, -5:]
    in_top5 = float(np.mean([lg[i].argmax() in top5[i] for i in range(BATCH)]))
    agree = float(np.mean(lg_base.argmax(-1) == lg.argmax(-1)))
    if in_top5 != 1.0 or agree < 0.75:
        raise AssertionError(f"ResNet-18 fused vs baseline: in top-5 {in_top5}, argmax "
                             f"agreement {agree}")
    # the simulator: on the card vs the same function on the CPU
    sim = {}
    for name, ranges, rtol in (("float", None, SIM_RTOL),
                               ("fake_quant", prep.act_ranges, SIM_FQ_RTOL)):
        with torch.no_grad():
            on_card = execute(prep.graph, prep.params, x8, act_ranges=ranges,
                              device=DEVICE).cpu().numpy()
            on_cpu = execute(prep.graph, prep.params, x8.cpu(), act_ranges=ranges,
                             device="cpu").numpy()
        d = float(np.abs(on_card - on_cpu).max())
        peak = float(np.abs(on_cpu).max())
        sim[name] = {"max_abs": d, "max_logit": peak, "limit": rtol * peak,
                     "argmax_agree": float(np.mean(on_card.argmax(-1) == on_cpu.argmax(-1)))}
        if not np.isfinite(on_card).all() or d > rtol * peak:
            raise AssertionError(f"ResNet-18 simulator ({name}) card vs CPU: max abs {d} "
                                 f"> {rtol} x {peak}")
    print(f"ResNet-18: logits {lg.shape} finite, max abs vs plain {diff}, launches {launches}, "
          f"conv epilogue {EPILOGUE_SEEN['resnet18']}; "
          f"baseline engine: fused top-1 in its top 5 {in_top5}, argmax agreement {agree}; "
          f"simulator card vs CPU {sim}", flush=True)
    return {"prep": prep, "model": model, "residual": residual, "net": net, "base": base,
            "launches": launches,
            "detail": {"launches": launches, "max_abs_vs_plain": diff, "in_top5": in_top5,
                       "argmax_agree_baseline": agree, "simulator": sim,
                       "argmax": lg.argmax(-1).tolist()}}


def conv_work(graph, name: str, batch: int, size: int) -> int:
    """MACs of one conv at ``batch`` and input ``size``."""
    node = graph[name]
    out = site_inputs(graph, batch, size)[name]
    a = node.attrs
    return int(np.prod(out)) * a["in_ch"] // a["groups"] * a["kernel"][0] * a["kernel"][1]


def phase_exact_products(paths, gen) -> dict:
    """9. Every packed int8 product that is not a kernel (every lowered conv
    and linear of the baseline engine, every non-kernel conv of the fused
    engine) against float64 on the card, at two batches and, at the
    largest site of each route of each model, a larger one: bit-equal
    int32. ``paths``: ``(model, graph, [(engine name, engine)], input
    size, (batch, odd batch, large batch))``."""
    import torch
    import torch.nn.functional as F

    from dfq_tpu_torch.engine.int8 import int8_conv, int8_linear

    n_checked = 0
    routes = {}
    for model_name, graph, engines, size, (b_main, b_odd, b_big) in paths:
        order = {x.name: i for i, x in enumerate(graph)}
        names = sorted({n for _, e in engines for n in e.products}, key=order.get)
        route = {n: next(e.products[n].route for _, e in engines if n in e.products)
                 for n in names}
        convs = [n for n in names if graph[n].op == "conv"]
        big = {max((n for n in convs if route[n] == r),
                   key=lambda n: conv_work(graph, n, 1, size))
               for r in set(route[n] for n in convs)}
        checks = [(n, b) for b in (b_main, b_odd) if b for n in names] + [
            (n, b_big) for n in sorted(big) if b_big]
        for name, batch in checks:
            node = graph[name]
            shape = site_inputs(graph, batch, size)[node.inputs[0]]
            x = torch.randint(-128, 128, shape, generator=gen, device=DEVICE,
                              dtype=torch.int8)
            layer = engines[0][1].model.layers[name]
            qw = torch.from_numpy(layer.qweight).to(DEVICE, torch.float64)
            zp = layer.in_zp
            if node.op == "conv":
                a = node.attrs
                (ph, pw) = a["padding"]
                xp = F.pad(x.permute(0, 3, 1, 2).double(), (pw, pw, ph, ph), value=zp)
                want = F.conv2d(xp, qw, stride=a["stride"], dilation=a["dilation"],
                                groups=a["groups"]).permute(0, 2, 3, 1).to(torch.int32)
                del xp
            else:
                want = (x.double() @ qw.t()).to(torch.int32)
            del qw
            for eng_name, eng in engines:
                if name not in eng.products:
                    continue
                prod = eng.products[name]
                got = (int8_conv(x, node, prod, zp) if node.op == "conv"
                       else int8_linear(x, prod))
                torch.cuda.synchronize()
                if got.dtype != torch.int32 or not torch.equal(got, want):
                    bad = int((got != want).sum()) if got.shape == want.shape else "shape"
                    raise AssertionError(
                        f"{model_name} {eng_name} {name} ({prod.route}) b{batch} "
                        f"{tuple(shape)}: {bad} int32 accumulators differ from float64")
                n_checked += 1
                routes[f"{model_name}/{name}"] = prod.route
                del got
            del x, want
        print(f"{model_name}: {len(names)} exact int8 products (routes "
              f"{ {r: sum(1 for n in names if route[n] == r) for r in set(route.values())} }) "
              f"bit-equal to float64 at batch {b_main}"
              + (f" and {b_odd}" if b_odd else "")
              + (f", and at batch {b_big} at {sorted(big)}" if b_big else ""), flush=True)
    return {"checks": n_checked, "routes": routes}


def kernel_site_checks(net, graph, size, batches, big_batch, ck) -> list:
    """Every site at each of ``batches``; at ``big_batch`` the K1 site with
    the most rows, every K1 site whose N is not a multiple of 8 (stored at
    any byte width), the largest K2 site of each stride, and K3's first and
    last."""
    by = {k: [s for s in net.kernel_sites if s[1] == k] for k in ck.LAUNCHES}
    shapes1 = site_inputs(graph, 1, size)

    def elems(site):
        return int(np.prod(shapes1[graph[site[0]].inputs[0]]))

    def rows(site):
        return int(np.prod(shapes1[graph[site[0]].inputs[0]][:-1]))

    big = []
    if by["matmul_int8_requant"]:
        k1 = by["matmul_int8_requant"]
        big.append(max(k1, key=rows))
        big += [s for s in k1 if s[2].n_out % 8 and s not in big]
    for stride in (1, 2):
        k2 = [s for s in by["dw3x3_int8_requant"] if s[2].stride == stride]
        if k2:
            big.append(max(k2, key=elems))
    if by["fused_block_int8"]:
        big += [by["fused_block_int8"][0], by["fused_block_int8"][-1]]
    return [(s, b) for b in batches for s in net.kernel_sites] + [(s, big_batch) for s in big]


def k1_on_tensor_cores(label: str, variants: dict) -> None:
    """Raise if a forward launched K1's dp4a variant: every K1 site of every
    path takes the tensor cores (the resident or the streamed variant)."""
    if variants["matmul_int8_requant"]["dp4a"]:
        raise AssertionError(f"{label}: K1 launched its dp4a variant: {variants}")


def step_by_step(net, x):
    """``net``'s forward (an ``Int8FusedNet``) on ``x`` run step by step,
    as a key's first forward runs it, whatever keys the net has seen: the
    kernels' counters then count every launch of the forward (a CUDA
    graph's replay calls no wrapper; :func:`replayed_kernels` reads its
    kernels from a trace)."""
    low = net.lowering(net.per_device_batch or x.shape[0])
    return net._outputs(net._run_steps(low.steps, {net.input_name: x}, set()))


EPILOGUE_KERNEL = r"\bconv_epilogue_rows_kernel\b"
MM_VARIANTS = ("mma", "stream", "dp4a")
MM_VARIANT = r"\bmm_(mma|stream|dp4a)_kernel\b"


def replayed_kernels(fn):
    """``fn()`` twice, then a third time under ``torch.profiler``, by when
    every fused forward in it replays its key's CUDA graph (raises if one
    captured or ran step by step): ``(output, device calls of each
    hand-written kernel, K1's calls by variant, the epilogue's calls)``
    in the trace of the third, the kernels named as the benchmark's trace
    names them (``portbench.trace.kernel_of``)."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from dfq_tpu_torch.engine import int8_fused
    from portbench.trace import KERNELS, kernel_of

    with torch.no_grad():
        fn()
        fn()
        torch.cuda.synchronize()
        before = dict(int8_fused.GRAPH_COUNTS)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in int8_fused.GRAPH_COUNTS.items()}
    if moved["captures"] or moved["eager"] or not moved["replays"]:
        raise AssertionError(f"the traced call did not only replay: {moved}")
    calls, variants, epilogue = dict.fromkeys(KERNELS, 0), dict.fromkeys(MM_VARIANTS, 0), 0
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if re.search(EPILOGUE_KERNEL, e.name):
            epilogue += 1
        k = kernel_of(e.name)
        if k is not None:
            calls[k] += 1
        m = re.search(MM_VARIANT, e.name)
        if m:
            variants[m.group(1)] += 1
    return out, calls, {"matmul_int8_requant": variants}, epilogue


def launch_forward(ck, net, x):
    """One forward of ``net`` run step by step (:func:`step_by_step`) with
    the counts reset just before it: ``(output, launches, variants)``; K1
    on the tensor cores only, and the glue convs' epilogue launched as
    :func:`epilogue_launches` says."""
    import torch

    from dfq_tpu_torch.ops import conv_epilogue as cep

    with torch.no_grad():
        ck.reset_counts()
        cep.reset_counts()
        out = step_by_step(net, x)
        torch.cuda.synchronize()
    variants = {k: dict(v) for k, v in ck.VARIANTS.items()}
    k1_on_tensor_cores(type(net).__name__, variants)
    epilogue_launches(type(net).__name__, net, x.shape[0])
    return out, dict(ck.LAUNCHES), variants


def epilogue_launches(label: str, net, batch: int, pin: str = None) -> int:
    """The glue convs' epilogue launches since its counts were reset, as
    one forward of ``net`` at ``batch`` must make them: one a glue
    ``conv`` step where the net runs its kernels (``EPILOGUE_PINS[pin]``
    of them on a pinned path, kept in ``EPILOGUE_SEEN``), none where it
    runs their plain versions, and no plain run through the wrapper."""
    from dfq_tpu_torch.ops import conv_epilogue as cep

    steps = len(net.lowering(net.per_device_batch or batch).epilogue_sites)
    want = steps if net.use_kernels and not net.plain_kernels else 0
    got = (cep.EPILOGUE_LAUNCHES, cep.EPILOGUE_PLAIN_CALLS)
    if got != (want, 0) or (pin is not None and got[0] != EPILOGUE_PINS[pin]):
        raise AssertionError(f"{label}: conv epilogue launches and plain runs {got}, "
                             f"{steps} glue conv steps"
                             + ("" if pin is None else f", {EPILOGUE_PINS[pin]} pinned"))
    if pin is not None:
        EPILOGUE_SEEN[label] = got[0]
    return got[0]


def epilogue_accs(net, graph, size: int, batch: int, gen):
    """``(node, acc, op)`` of each glue conv site of ``net``'s lowering at
    ``batch``: the site's own product (its route) on a random int8 input,
    and its packed epilogue."""
    import torch

    shapes = site_inputs(graph, batch, size)
    for name, acc_of, op in net.lowering(batch).epilogue_sites:
        x = torch.randint(-128, 128, shapes[graph[name].inputs[0]], generator=gen,
                          device=DEVICE, dtype=torch.int8)
        with torch.no_grad():
            acc = acc_of(x)
        del x
        yield name, acc, op


def hold_epilogue(label: str, acc, op, max_err: dict):
    """The epilogue kernel on ``acc`` against its plain version: bit-equal,
    or raise; ``max_err["conv_epilogue"]`` keeps the largest difference.
    Returns the kernel's output."""
    import torch

    from dfq_tpu_torch.ops import conv_epilogue as cep

    got = cep.conv_epilogue_packed(acc, op)
    torch.cuda.synchronize()
    want = cep.conv_epilogue_plain(acc, op)
    torch.cuda.synchronize()
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"conv_epilogue at {label}: {got.dtype}{tuple(got.shape)} vs "
                             f"plain {want.dtype}{tuple(want.shape)}")
    err = float((got.double() - want.double()).abs().max())
    max_err["conv_epilogue"] = max(max_err.get("conv_epilogue", 0.0), err)
    if not torch.equal(got, want):
        raise AssertionError(f"conv_epilogue at {label} {tuple(acc.shape)} {acc.dtype}: "
                             f"{int((got != want).sum())} elements differ from the plain "
                             f"version (max abs {err})")
    return got


def equal_outputs(label, got, want) -> None:
    import torch

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            d = float((a.double() - b.double()).abs().max())
            raise AssertionError(f"{label}: max abs {d}")


def host_keep_sets(conf, loc, priors, prob_threshold, iou_threshold, top_k):
    """The host NMS of ``Predictor`` for one image: ``{class: [K, 5]}``."""
    from dfq_tpu_torch.detection import box_utils

    boxes = box_utils.center_form_to_corner_form(
        box_utils.convert_locations_to_boxes(loc, priors, 0.1, 0.2))
    kept = {}
    for c in range(1, conf.shape[1]):
        m = conf[:, c] > prob_threshold
        if m.any():
            bp = np.concatenate([boxes[m], conf[m, c, None]], 1).astype(np.float32)
            kept[c] = box_utils.hard_nms(bp, iou_threshold, top_k=top_k, candidate_size=200)
    return kept


def phase_ssd(ck, wrappers, max_err: dict, gen, out_dir: Path) -> dict:
    """12. SSD-Lite 300x300 through the fused engine, the baseline engine,
    device NMS and its entry point."""
    import shutil

    import torch

    from dfq_tpu_torch.cli import run_ssd
    from dfq_tpu_torch.detection.device_nms import decode_nms_batch
    from dfq_tpu_torch.engine import Int8FusedNet, Int8Net
    from dfq_tpu_torch.io import load_artifact
    from dfq_tpu_torch.models import mobilenet_v2_ssd_lite
    from dfq_tpu_torch.models.ssd import SSDConfig, quantized_priors

    prep, model, residual = flagship(mobilenet_v2_ssd_lite, **DET)
    graph = model.graph
    net = Int8FusedNet(model, device=DEVICE, params_f32=residual)
    ref_net = Int8FusedNet(model, device=DEVICE, plain_kernels=True, params_f32=residual)
    base = Int8Net(model, residual, device=DEVICE)
    kinds = {k: sum(1 for _, kk, _ in net.kernel_sites if kk == k) for k in wrappers}
    if kinds != {"matmul_int8_requant": 30, "dw3x3_int8_requant": 19, "fused_block_int8": 12}:
        raise AssertionError(f"SSD-Lite kernel sites {kinds}")
    checks = kernel_site_checks(net, graph, SSD_SIZE, (BATCH, ODD_BATCH), BIG_BATCH, ck)
    hold_sites(graph, SSD_SIZE, checks, wrappers, max_err, gen)
    big = sorted({c[0][0] for c in checks if c[1] == BIG_BATCH})
    print(f"SSD-Lite: kernels == plain at all {len(net.kernel_sites)} sites at batch {BATCH} "
          f"and {ODD_BATCH}, and at batch {BIG_BATCH} at {big}", flush=True)

    config = SSDConfig()
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 255, (BIG_BATCH, SSD_SIZE, SSD_SIZE, 3)).astype(np.float32)
    # the predictor's normalization of a 300x300 image
    inputs = (images - np.float32(127.0)) / np.float32(128.0)
    x8 = torch.from_numpy(inputs[:BATCH]).to(DEVICE)
    (conf, loc), launches, variants = launch_forward(ck, net, x8)
    epilogue_launches("ssd_lite", net, BATCH, pin="ssd_lite")
    if launches != {"matmul_int8_requant": 30, "dw3x3_int8_requant": 19, "fused_block_int8": 12}:
        raise AssertionError(f"SSD-Lite launches {launches}")
    if variants != {"matmul_int8_requant": {"mma": 30, "stream": 0, "dp4a": 0},
                    "dw3x3_int8_requant": {"strip": 11, "general": 0, "strip_s2": 8,
                                           "general_s2": 0},
                    "fused_block_int8": {"mma": 12, "general": 0}}:
        raise AssertionError(f"SSD-Lite kernel variants {variants}")
    if ck.PLAIN_CALLS != dict.fromkeys(wrappers, 0):
        raise AssertionError(f"plain versions ran through the wrappers: {ck.PLAIN_CALLS}")
    with torch.no_grad():
        equal_outputs("SSD-Lite vs plain versions", (conf, loc), ref_net(x8))
        b_conf, b_loc = base(x8)
    c, l, bc, bl = (t.cpu().numpy() for t in (conf, loc, b_conf, b_loc))
    if c.shape != (BATCH, 3000, 21) or l.shape != (BATCH, 3000, 4) or not (
            np.isfinite(c).all() and np.isfinite(l).all()):
        raise AssertionError(f"SSD-Lite outputs {c.shape} {l.shape}")
    sums = float(np.abs(c.sum(-1) - 1).max())
    if sums > 1e-4:
        raise AssertionError(f"SSD-Lite confidences sum to 1 within {sums}")
    card_cpu = hold_engines_card_vs_cpu("SSD-Lite", model, residual, x8, ENGINE_RTOL)
    # the JAX suite's bounds between an int8 engine and the simulator
    # (tests/test_int8_seg_det.py:176-181), here between the two engines
    conf_mean, loc_mean = float(np.abs(c - bc).mean()), float(np.abs(l - bl).mean())
    if conf_mean >= 0.05 or loc_mean >= 0.5 * float(np.abs(bl).mean()):
        raise AssertionError(f"SSD-Lite fused vs baseline: conf mean {conf_mean}, "
                             f"loc mean {loc_mean}")

    # device NMS on the card against the host NMS on the same outputs
    priors = quantized_priors(config)
    kw = dict(prob_threshold=0.01, iou_threshold=0.45, candidate_size=200, top_k=200)
    db, ds, dv = (t.cpu().numpy() for t in decode_nms_batch(
        conf, loc, torch.from_numpy(priors).to(DEVICE), **kw))
    n_kept = 0
    for i in range(BATCH):
        host = host_keep_sets(c[i], l[i], priors, 0.01, 0.45, 200)
        for cls in range(1, 21):
            n = int(dv[i, cls - 1].sum())
            ref = host.get(cls, np.zeros((0, 5), np.float32))
            if n != len(ref) or not dv[i, cls - 1, :n].all() or not np.array_equal(
                    ds[i, cls - 1, :n], ref[:, 4]) or not np.allclose(
                    db[i, cls - 1, :n], ref[:, :4], rtol=1e-5, atol=1e-6):
                raise AssertionError(f"device NMS image {i} class {cls}: {n} kept vs the "
                                     f"host's {len(ref)}")
            n_kept += n
    print(f"SSD-Lite b{BATCH}: outputs equal to the plain-kernel net's, launches {launches}, "
          f"variants {variants}; baseline card vs CPU {card_cpu}; fused vs baseline conf mean "
          f"{conf_mean}, loc mean {loc_mean}; device NMS keeps the host's {n_kept} boxes",
          flush=True)

    # the entry point
    art = out_dir / "ssd_art"
    cli = {}
    try:
        out = run_ssd.main(["--quantize", "--relu", "--equalize", "--engine", "fused",
                            "--device-nms"])
        cli["fused_device_nms_detections"] = len(out["detections"][1])
        out = run_ssd.main(["--quantize", "--relu", "--equalize", "--engine", "int8",
                            "--save-artifact", str(art)])
        m2, r2 = load_artifact(str(art))
        xs = np.concatenate([out["predictor"].preprocess(im) for im in run_ssd.smoke_images()])
        with torch.no_grad():
            again = Int8Net(m2, r2, device=DEVICE)(torch.from_numpy(xs).to(DEVICE))
        if not (np.array_equal(again[0].cpu().numpy(), out["conf"])
                and np.array_equal(again[1].cpu().numpy(), out["loc"])):
            raise AssertionError("run_ssd --engine int8: the reloaded artifact's outputs differ")
        cli["int8_host_nms_detections"] = len(out["detections"][1])
    finally:
        shutil.rmtree(art, ignore_errors=True)
    print(f"run_ssd: fused with device NMS and int8 with its artifact reloaded bit-equal {cli}",
          flush=True)
    return {"prep": prep, "model": model, "net": net, "base": base, "launches": launches,
            "inputs": inputs, "priors": priors,
            "detail": {"launches": launches, "variants": variants, "card_vs_cpu": card_cpu,
                       "fused_vs_baseline": {"conf_mean": conf_mean, "loc_mean": loc_mean},
                       "device_nms_kept": n_kept, "cli": cli}}


def phase_deeplab(ck, wrappers, max_err: dict, gen, out_dir: Path) -> dict:
    """13. DeepLab-v3+ MobileNetV2 513x513 through the fused engine, the
    baseline engine and its entry point."""
    import shutil

    import torch

    from dfq_tpu_torch.cli import run_seg
    from dfq_tpu_torch.engine import Int8FusedNet, Int8Net
    from dfq_tpu_torch.io import load_artifact
    from dfq_tpu_torch.models import deeplab_mobilenet_v2

    prep, model, residual = flagship(lambda: deeplab_mobilenet_v2(input_size=SEG_SIZE))
    graph = model.graph
    net = Int8FusedNet(model, device=DEVICE, params_f32=residual)
    ref_net = Int8FusedNet(model, device=DEVICE, plain_kernels=True, params_f32=residual)
    base = Int8Net(model, residual, device=DEVICE)
    kinds = {k: sum(1 for _, kk, _ in net.kernel_sites if kk == k) for k in wrappers}
    if kinds != {"matmul_int8_requant": 38, "dw3x3_int8_requant": 0, "fused_block_int8": 0}:
        raise AssertionError(f"DeepLab kernel sites {kinds}")
    checks = kernel_site_checks(net, graph, SEG_SIZE, (SEG_BATCH, ODD_BATCH), BIG_BATCH, ck)
    checks += [(s, BATCH) for s, b in checks if b == BIG_BATCH and s[2].n_out % 8]
    hold_sites(graph, SEG_SIZE, checks, wrappers, max_err, gen)
    print(f"DeepLab: kernels == plain at all {len(net.kernel_sites)} sites at batch {SEG_BATCH} "
          f"and {ODD_BATCH}, and at {sorted({(c[0][0], c[1]) for c in checks if c[1] > 4})}",
          flush=True)

    rng = np.random.default_rng(0)
    images = np.clip(rng.normal(0, 1, (BATCH, SEG_SIZE, SEG_SIZE, 3)),
                     -2.117, 2.64).astype(np.float32)
    x4 = torch.from_numpy(images[:SEG_BATCH]).to(DEVICE)
    out, launches, variants = launch_forward(ck, net, x4)
    epilogue_launches("deeplab_mnv2", net, SEG_BATCH, pin="deeplab_mnv2")
    if launches != {"matmul_int8_requant": 38, "dw3x3_int8_requant": 0, "fused_block_int8": 0}:
        raise AssertionError(f"DeepLab launches {launches}")
    if variants["matmul_int8_requant"] != {"mma": 38, "stream": 0, "dp4a": 0}:
        raise AssertionError(f"DeepLab kernel variants {variants}")
    if ck.PLAIN_CALLS != dict.fromkeys(wrappers, 0):
        raise AssertionError(f"plain versions ran through the wrappers: {ck.PLAIN_CALLS}")
    with torch.no_grad():
        equal_outputs("DeepLab vs plain versions", out, ref_net(x4))
        classes = out.argmax(-1).to(torch.uint8).cpu().numpy()  # on the card
        b_classes = base(x4).argmax(-1).cpu().numpy()
    if out.shape != (SEG_BATCH, SEG_SIZE, SEG_SIZE, 21) or not torch.isfinite(out).all():
        raise AssertionError(f"DeepLab output {tuple(out.shape)}")
    card_cpu = hold_engines_card_vs_cpu("DeepLab", model, residual, x4[:2], ENGINE_RTOL)
    # the JAX suite's agreement between the two engines (tests/test_int8_seg_det.py:95-98)
    agree = float(np.mean(classes == b_classes))
    if agree < 0.8:
        raise AssertionError(f"DeepLab fused vs baseline argmax agreement {agree}")
    print(f"DeepLab b{SEG_BATCH}: output equal to the plain-kernel net's, launches {launches}, "
          f"K1 variants {variants['matmul_int8_requant']}; baseline card vs CPU {card_cpu}; "
          f"fused vs baseline argmax agreement {agree}", flush=True)

    art = out_dir / "seg_art"
    cli = {}
    try:
        out = run_seg.main(["--quantize", "--relu", "--equalize", "--engine", "fused"])
        cli["fused_classes"] = int(len(np.unique(out["classes"])))
        out = run_seg.main(["--quantize", "--relu", "--equalize", "--engine", "int8",
                            "--save-artifact", str(art)])
        m2, r2 = load_artifact(str(art))
        with torch.no_grad():
            again = Int8Net(m2, r2, device=DEVICE)(
                torch.from_numpy(run_seg.smoke_images()).to(DEVICE)).cpu().numpy()
        if not np.array_equal(again, out["output"]):
            raise AssertionError("run_seg --engine int8: the reloaded artifact's output differs")
        cli["int8_classes"] = int(len(np.unique(out["classes"])))
    finally:
        shutil.rmtree(art, ignore_errors=True)
    print(f"run_seg: fused, and int8 with its artifact reloaded bit-equal {cli}", flush=True)
    return {"prep": prep, "model": model, "net": net, "base": base, "launches": launches,
            "images": images,
            "detail": {"launches": launches, "variants": variants, "card_vs_cpu": card_cpu,
                       "argmax_agree_baseline": agree, "cli": cli}}


def phase_epilogue(paths, gen, mem_bw: float, max_err: dict) -> dict:
    """13a. The glue convs' epilogue kernel (``ops/conv_epilogue.py``) at
    every glue conv site of the four paths, on the accumulator the site's
    own product leaves from a random int8 input: bit-equal to its plain
    version at each of the path's ``batches`` and at its benchmark cell's
    batch (``EPILOGUE_CELL_BATCH``), where each site is then timed: the
    kernel from the host (``ms``) and as a CUDA-graph replay
    (``device_ms``), the plain version (the torch chain it replaced; on the
    float routes with the int32 NHWC copy the product phase made before),
    and the bound: the accumulator's ``C`` channels read once and the
    output written once at the card's memory rate. Then the wrapper's host
    cost a call against a bare ctypes launch of the same arguments."""
    import ctypes

    import torch

    from dfq_tpu_torch.ops import conv_epilogue as cep

    sites, by_path = [], {}
    for path, net, graph, size, batches in paths:
        cell = EPILOGUE_CELL_BATCH[path]
        for batch in batches:
            for name, acc, op in epilogue_accs(net, graph, size, batch, gen):
                hold_epilogue(f"{path} {name} b{batch}", acc, op, max_err)
        mine = []
        for name, acc, op in epilogue_accs(net, graph, size, cell, gen):
            out = hold_epilogue(f"{path} {name} b{cell}", acc, op, max_err)
            shape = tuple(out.shape)
            variant = next(cep.EPI_VARIANTS[a.variant] for k, a in op.launch_args.items()
                           if tuple(k[0]) == shape and k[2] == acc.dtype)
            nbytes = out.numel() * (acc.element_size() + out.element_size())
            mine.append({
                "path": path, "batch": cell, "node": name, "shape": list(shape),
                "acc": str(acc.dtype).split(".")[1], "acc_strides": list(acc.stride()),
                "out": str(out.dtype).split(".")[1], "variant": variant,
                "ms": time_ms(lambda: cep.conv_epilogue_packed(acc, op), reps=10, rounds=3),
                "device_ms": graph_ms(lambda: cep.conv_epilogue_packed(acc, op), reps=10,
                                      rounds=3),
                "plain_ms": time_ms(lambda: cep.conv_epilogue_plain(acc, op), reps=3, rounds=3),
                "bytes": nbytes, "bound_ms": nbytes / mem_bw * 1e3})
            del acc, out
        torch.cuda.empty_cache()
        by_path[path] = {"batch": cell, "sites": len(mine),
                         **{k: sum(t[k] for t in mine)
                            for k in ("ms", "device_ms", "plain_ms", "bound_ms")}}
        sites += mine
    print("conv epilogue per site: path b node shape acc -> out variant | ms (host calls) | "
          "device ms (graph replay) | plain ms | bound ms (bytes) | bound / device ms")
    for t in sites:
        print(f"  {t['path']} b{t['batch']} {t['node']} {tuple(t['shape'])} {t['acc']} -> "
              f"{t['out']} {t['variant']} | {t['ms']:.4f} | {t['device_ms']:.4f} | "
              f"{t['plain_ms']:.3f} | {t['bound_ms']:.4f} | "
              f"{t['bound_ms'] / t['device_ms']:.1%}", flush=True)
    for path, r in by_path.items():
        print(f"conv epilogue {path} b{r['batch']}: {r['sites']} sites, ms {r['ms']:.4f}, device "
              f"ms {r['device_ms']:.4f}, plain ms {r['plain_ms']:.3f}, bound ms "
              f"{r['bound_ms']:.4f}", flush=True)

    # the wrapper's host cost: ResNet-18's last glue conv at b1 (a short
    # kernel, so the host's issue rate is what a loop of calls measures)
    path, net, graph, size, _ = next(p for p in paths if p[0] == "resnet18")
    name, acc, op = list(epilogue_accs(net, graph, size, 1, gen))[-1]
    out = cep.conv_epilogue_packed(acc, op)
    v = cep._nhwc_view(acc, op.channels)
    args = next(a for k, a in op.launch_args.items() if tuple(k[0]) == tuple(out.shape))
    fn, stream = cep._fn(), torch.cuda.current_stream().cuda_stream
    calls = 2000

    def per_call_us(call) -> float:
        per = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                call()
            per.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
        return float(np.median(per))

    host = {"node": f"resnet18 {name} b1", "shape": list(out.shape),
            "wrapper_us": per_call_us(lambda: cep.conv_epilogue_packed(acc, op)),
            "bare_launch_us": per_call_us(lambda: fn(ctypes.byref(args), v.data_ptr(),
                                                     out.data_ptr(), stream))}
    host["wrapper_ms_per_forward"] = {p: host["wrapper_us"] * n / 1e3
                                      for p, n in EPILOGUE_PINS.items()}
    print(f"conv epilogue host cost a call ({host['node']}): wrapper {host['wrapper_us']:.2f} "
          f"us, bare ctypes launch {host['bare_launch_us']:.2f} us; wrapper ms a forward "
          f"{host['wrapper_ms_per_forward']}", flush=True)
    return {"sites": sites, "by_path": by_path, "host": host}


def phase_cli(out_dir: Path) -> dict:
    """10. The classification entry point in-process, fused then int8, each
    saving its artifact; the reloaded artifact through the same engine
    reproduces the entry point's logits bit for bit."""
    import shutil

    import torch

    from dfq_tpu_torch.cli import run_cls
    from dfq_tpu_torch.engine import Int8FusedNet, Int8Net
    from dfq_tpu_torch.io import load_artifact

    art = out_dir / "r18_art"
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (8, 224, 224, 3)).astype(
        np.float32)).to(DEVICE)
    result = {}
    try:
        for engine in ("fused", "int8"):
            out = run_cls.main(["--resnet", "--quantize", "--relu", "--equalize",
                                "--engine", engine, "--save-artifact", str(art)])
            model, residual = load_artifact(str(art))
            net = (Int8FusedNet(model, device=DEVICE, params_f32=residual) if engine == "fused"
                   else Int8Net(model, residual, device=DEVICE))
            with torch.no_grad():
                again = net(x).cpu().numpy()
            if not np.array_equal(again, out["logits"]):
                raise AssertionError(f"run_cls --engine {engine}: the reloaded artifact's "
                                     f"logits differ (max abs "
                                     f"{float(np.abs(again - out['logits']).max())})")
            result[engine] = {"argmax": out["logits"].argmax(-1).tolist()}
    finally:
        shutil.rmtree(art, ignore_errors=True)
    print(f"run_cls --resnet: fused and int8 engines, artifacts reloaded bit-equal {result}",
          flush=True)
    return result


def distill_timed(graph, params, cfg):
    """One capped ``distill_batch_fn`` run on the card after a 2-step
    warm-up: ``(images, steps, last loss, ms per step between CUDA events,
    peak device bytes)``."""
    import dataclasses

    import torch

    from dfq_tpu_torch.calib.distill import distill_batch_fn, init_random_batch

    x0 = init_random_batch(np.random.default_rng(0), cfg)
    distill_batch_fn(graph, params, dataclasses.replace(cfg, max_iters=2))(x0)
    run = distill_batch_fn(graph, params, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    x, steps, last = run(x0)
    end.record()
    end.synchronize()
    return x, steps, last, start.elapsed_time(end) / steps, int(torch.cuda.max_memory_allocated())


def phase_calibration(ck, wrappers, max_err: dict, gen, images) -> dict:
    """14. ZeroQ calibration (``--distill_range``) on MobileNetV2 224x224:
    the distillation at run_cls's batch (timed, f32 and bf16; the f32 loss
    and gradient at the seed batch equal to the CPU's), ``calibrate_ranges``
    on the card against the CPU, the calibrated model through
    ``lower_int8`` and ``Int8FusedNet`` (launches, variants, every kernel
    bit-equal to its plain version at every site under the calibrated
    constants, the forward bit-equal to the plain-kernel net), the entry
    point in-process with its own step budget, and the distillation step
    at SSD-Lite 300x300 and DeepLab 513x513."""
    import dataclasses

    import torch

    from dfq_tpu_torch.calib import DistillConfig, calibrate_ranges
    from dfq_tpu_torch.calib.distill import init_random_batch, loss_and_grad, make_loss_fn
    from dfq_tpu_torch.cli import run_cls
    from dfq_tpu_torch.engine import Int8FusedNet, lower_int8
    from dfq_tpu_torch.models import (
        deeplab_mobilenet_v2,
        init_params,
        mobilenet_v2,
        mobilenet_v2_ssd_lite,
    )
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    def prepared(graph, **flags):
        cfg = QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                          correction=True, bits_bias=16, distill_range=True, **flags)
        return prepare(graph, init_params(graph, seed=0, bn_stats="random"), cfg)

    detail = {}
    prep = prepared(mobilenet_v2())
    # the distillation at run_cls's batch, both compute types
    runs = {}
    for dtype in ("f32", "bf16"):
        cfg = DistillConfig(batch_size=DIS_BATCH, num_batch=1, early_break_factor=0.5,
                            max_iters=DIS_STEPS, compute_dtype=dtype, device=DEVICE)
        x, steps, last, ms, peak = distill_timed(prep.graph, prep.params_fp, cfg)
        runs[dtype] = x.cpu().numpy()
        detail[f"distill_{dtype}"] = {"batch": DIS_BATCH, "steps": steps, "last_loss": last,
                                      "ms_per_step": ms, "peak_bytes": peak}
        print(f"distill MobileNetV2 224x224 b{DIS_BATCH} {dtype}: {steps} steps, last loss "
              f"{last:.4f}, {ms:.3f} ms/step, peak device memory {peak / 2**30:.3f} GiB",
              flush=True)
    ratio = detail["distill_bf16"]["last_loss"] / detail["distill_f32"]["last_loss"]
    if not np.isfinite(ratio) or ratio > 1.25:
        raise AssertionError(f"bf16 distillation loss {ratio:.4f}x the f32 loss after "
                             f"{DIS_STEPS} steps (limit 1.25)")
    # the f32 loss and gradient at the seed batch: card vs CPU
    cfg = DistillConfig(batch_size=DIS_BATCH, compute_dtype="f32")
    x0 = init_random_batch(np.random.default_rng(0), cfg)
    grads = {}
    for dev in (DEVICE, "cpu"):
        loss_fn, _ = make_loss_fn(prep.graph, prep.params_fp,
                                  dataclasses.replace(cfg, device=dev))
        loss, g = loss_and_grad(loss_fn, torch.from_numpy(x0).to(dev))
        grads[dev] = (float(loss), g.cpu().numpy())
    (l_card, g_card), (l_cpu, g_cpu) = grads[DEVICE], grads["cpu"]
    loss_rel = abs(l_card - l_cpu) / abs(l_cpu)
    grad_rel = float(np.abs(g_card - g_cpu).max() / np.abs(g_cpu).max())
    # what the same gradient parts by with TF32 allowed (not the path's)
    torch.backends.cuda.matmul.allow_tf32 = True
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        loss_fn, _ = make_loss_fn(prep.graph, prep.params_fp,
                                  dataclasses.replace(cfg, device=DEVICE))
        x = torch.from_numpy(x0).to(DEVICE).requires_grad_(True)
        (g_tf32,) = torch.autograd.grad(loss_fn(x), x)
    torch.backends.cuda.matmul.allow_tf32 = False
    tf32_rel = float(np.abs(g_tf32.cpu().numpy() - g_cpu).max() / np.abs(g_cpu).max())
    detail["loss_grad_card_vs_cpu"] = {"loss_card": l_card, "loss_cpu": l_cpu,
                                       "loss_rel": loss_rel, "grad_rel_of_max": grad_rel,
                                       "grad_rel_of_max_tf32_backward": tf32_rel}
    if loss_rel > DIS_LOSS_RTOL or grad_rel > DIS_GRAD_RTOL:
        raise AssertionError(f"distillation loss card vs CPU rel {loss_rel} (limit "
                             f"{DIS_LOSS_RTOL}), gradient {grad_rel} of its max (limit "
                             f"{DIS_GRAD_RTOL})")
    print(f"distillation f32 at the seed batch, card vs CPU: loss {l_card} vs {l_cpu} (rel "
          f"{loss_rel:.2e}), gradient {grad_rel:.2e} of its max (limits {DIS_LOSS_RTOL}, "
          f"{DIS_GRAD_RTOL}; with TF32 in the backward {tf32_rel:.2e})", flush=True)
    # calibrate_ranges on the distilled batches: card vs CPU
    batches = [runs["f32"], runs["bf16"]]
    ranges = calibrate_ranges(prep.graph, prep.params, batches, device=DEVICE)
    ranges_cpu = calibrate_ranges(prep.graph, prep.params, batches, device="cpu")
    # the self-quant forwards flip fake-quant ties where the two backends'
    # f32 sums part in the last bit, and later sites carry a flip on (the
    # simulator's divergence, ROADMAP.md section 3): most sites within one
    # fake-quant step, every one within 2% of its span, as the CPU test
    # holds the port against JAX (tests/test_torch_zeroq_cli.py)
    steps_off = {s: max(abs(a - b) for a, b in zip(ranges[s], ranges_cpu[s]))
                 / ((ranges_cpu[s][1] - ranges_cpu[s][0]) / 255.0) for s in ranges_cpu}
    worst = max(steps_off, key=steps_off.get)
    within = sum(v <= 1.0 for v in steps_off.values())
    detail["ranges_card_vs_cpu"] = {"max_steps": steps_off[worst], "worst_site": worst,
                                    "sites_within_one_step": within, "sites": len(steps_off)}
    if (ranges.keys() != ranges_cpu.keys() or within < 0.9 * len(steps_off)
            or steps_off[worst] > 0.02 * 255):
        raise AssertionError(f"calibrate_ranges card vs CPU: {within} of {len(steps_off)} "
                             f"sites within a fake-quant step; {worst} {steps_off[worst]} "
                             f"steps apart")
    print(f"calibrate_ranges: {len(ranges)} sites, card vs CPU: {within} within one "
          f"fake-quant step, at most {steps_off[worst]:.3f} steps ({worst})", flush=True)
    # the kernels under the calibrated constants
    prep.act_ranges = ranges
    model = lower_int8(prep)
    net = Int8FusedNet(model, device=DEVICE)
    ref_net = Int8FusedNet(model, device=DEVICE, plain_kernels=True)
    x8 = torch.from_numpy(images[:BATCH]).to(DEVICE)
    logits, launches, variants = launch_forward(ck, net, x8)
    epilogue_launches("mobilenet_v2_calibrated", net, BATCH, pin="mobilenet_v2")
    if launches != {"matmul_int8_requant": 11, "dw3x3_int8_requant": 5,
                    "fused_block_int8": 12}:
        raise AssertionError(f"calibrated path launches {launches}")
    if variants != {"matmul_int8_requant": {"mma": 11, "stream": 0, "dp4a": 0},
                    "dw3x3_int8_requant": {"strip": 1, "general": 0, "strip_s2": 4,
                                           "general_s2": 0},
                    "fused_block_int8": {"mma": 12, "general": 0}}:
        raise AssertionError(f"calibrated path kernel variants {variants}")
    if ck.PLAIN_CALLS != dict.fromkeys(wrappers, 0):
        raise AssertionError(f"plain versions ran through the wrappers: {ck.PLAIN_CALLS}")
    with torch.no_grad():
        ref = ref_net(x8)
    equal_outputs("calibrated MobileNetV2 forward vs its plain-kernel net", logits, ref)
    lg = logits.cpu().numpy()
    if lg.shape != (BATCH, 1000) or not np.isfinite(lg).all():
        raise AssertionError(f"calibrated logits {lg.shape}, finite={np.isfinite(lg).all()}")
    checks = ([(s, BATCH) for s in net.kernel_sites] + [(s, ODD_BATCH) for s in net.kernel_sites])
    hold_sites(model.graph, SIZE, checks, wrappers, max_err, gen)
    # the constants the BN-derived ranges never gave: zero points and ratios
    zps = sorted({op.zp_in for _, _, op in net.kernel_sites if hasattr(op, "zp_in")})
    print(f"calibrated path: launches {launches}, variants {variants}, forward bit-equal to "
          f"the plain-kernel net, every kernel == plain at all {len(net.kernel_sites)} sites "
          f"at batch {BATCH} and {ODD_BATCH}; input zero points {zps}", flush=True)
    detail.update(launches=launches, variants=variants, argmax=lg.argmax(-1).tolist())
    # the entry point in-process, with its own step budget
    t0 = time.perf_counter()
    out = run_cls.main(["--quantize", "--relu", "--equalize", "--distill_range", "--engine",
                        "fused", "--dis_batch_size", str(DIS_BATCH_SEG_DET),
                        "--dis_num_batch", "1"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    if not np.isfinite(out["logits"]).all():
        raise AssertionError("run_cls --distill_range: logits not finite")
    detail["cli_wall_s"] = cli_s
    print(f"run_cls --quantize --relu --equalize --distill_range --engine fused "
          f"--dis_batch_size {DIS_BATCH_SEG_DET} --dis_num_batch 1: {cli_s:.1f} s wall",
          flush=True)
    # the distillation step of the detection and segmentation CLIs
    for name, graph, flags, dcfg in (
            ("ssd_lite", mobilenet_v2_ssd_lite(num_classes=21), DET,
             dict(image_size=(SSD_SIZE, SSD_SIZE), value_range=(-1.0, 1.0), max_value=1.0,
                  early_break_factor=0.04)),
            ("deeplab_mnv2", deeplab_mobilenet_v2(input_size=SEG_SIZE), {},
             dict(image_size=(SEG_SIZE, SEG_SIZE), early_break_factor=0.2))):
        p = prepared(graph, **flags)
        cfg = DistillConfig(batch_size=DIS_BATCH_SEG_DET, num_batch=1,
                            max_iters=DIS_STEPS_SEG_DET, device=DEVICE, **dcfg)
        _, steps, last, ms, peak = distill_timed(p.graph, p.params_fp, cfg)
        detail[f"distill_{name}"] = {"batch": DIS_BATCH_SEG_DET, "steps": steps,
                                     "last_loss": last, "ms_per_step": ms, "peak_bytes": peak}
        print(f"distill {name} b{DIS_BATCH_SEG_DET} bf16: {steps} steps, {ms:.3f} ms/step, "
              f"peak device memory {peak / 2**30:.3f} GiB", flush=True)
        del p
    torch.cuda.empty_cache()
    return {"launches": launches, "detail": detail}


def cpu_model() -> str:
    """The host CPU's model name as ``lscpu`` prints it, with the vendor,
    family and model numbers of ``/proc/cpuinfo`` beside it (a virtual
    machine's ``lscpu`` may say ``unknown``)."""
    import shutil

    name = "no lscpu"
    if shutil.which("lscpu"):
        out = subprocess.run(["lscpu"], check=True, capture_output=True, text=True,
                             timeout=60).stdout
        name = next((line.split(":", 1)[1].strip() for line in out.splitlines()
                     if line.startswith("Model name:")), "no model name")
    info = {}
    for line in Path("/proc/cpuinfo").read_text().splitlines():
        key = line.split(":", 1)[0].strip()
        if key in ("vendor_id", "cpu family", "model", "model name") and key not in info:
            info[key] = line.split(":", 1)[1].strip()
    return (f"{name} (/proc/cpuinfo: {info.get('model name')}, {info.get('vendor_id')} "
            f"family {info.get('cpu family')} model {info.get('model')}, "
            f"{os.cpu_count()} CPUs)")


def host_ms(fn, rounds: int = 5) -> float:
    """Median wall ms of ``fn()`` on the host's clock, after one warm-up."""
    fn()
    per = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        fn()
        per.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(per))


def phase_deployment(root: Path, out_dir: Path) -> dict:
    """15. The native deployment path: ``libdfqrt`` built by the port with
    g++, ``convert --relu --equalize --validate`` in-process (MobileNetV2
    224x224, full width, the seed's random weights), the golden artifact's
    native files re-exported byte for byte and run through the runtime,
    the runtime on the host against ``Int8Net`` on the card."""
    import filecmp
    import shutil

    from dfq_tpu_torch.cli import convert
    from dfq_tpu_torch.engine import native
    from dfq_tpu_torch.io import load_artifact
    from dfq_tpu_torch.io.native_export import save_native_artifact

    t0 = time.perf_counter()
    lib = native.build_native()
    build_s = time.perf_counter() - t0
    work_dir = out_dir / "deployment"
    shutil.rmtree(work_dir, ignore_errors=True)
    try:
        prefix = str(work_dir / "mnv2")
        out = convert.main(["--relu", "--equalize", "--validate", "--out", prefix,
                            "--device", DEVICE])
        # the golden artifact reloaded and exported again, and convert's own
        # artifact: the same bytes as the files they came with
        model, residual = load_artifact(str(root / "golden" / "artifact"))
        save_native_artifact(str(work_dir / "golden"), model, residual)
        model, residual = load_artifact(prefix)
        save_native_artifact(str(work_dir / "again"), model, residual)
        for a, b in ((work_dir / "golden", root / "golden" / "model_native"),
                     (work_dir / "again", Path(prefix + "_native"))):
            for ext in (".dfqparam", ".dfqbin"):
                if not filecmp.cmp(str(a) + ext, str(b) + ext, shallow=False):
                    raise AssertionError(f"native export {a}{ext} differs from {b}{ext}")
        # the golden model through the runtime
        x = np.load(root / "golden" / "input.npy")
        want = np.load(root / "golden" / "logits.npy")
        got = native.NativeModel(str(root / "golden" / "model_native"), lib_path=lib).forward(x)[0]
        golden_diff = float(np.abs(got - want).max()) if got.shape == want.shape else float("inf")
        if golden_diff > 1e-4 or not (got.argmax(-1) == want.argmax(-1)).all():
            raise AssertionError(f"native runtime on golden/: max abs {golden_diff}")
        # the runtime on the host against Int8Net on the card, 2 images
        # (tests/test_native_runtime.py:62-67's contract)
        d = np.abs(out["native"] - out["engine"])
        within = float(np.mean(d < 5e-3))
        if not (d.mean() < 2e-3 and d.max() < 5e-2 and within > 0.9
                and (out["native"].argmax(-1) == out["engine"].argmax(-1)).all()):
            raise AssertionError(f"native vs card: mean {d.mean()}, max {d.max()}, within "
                                 f"5e-3 {within}")
        nm = native.NativeModel(prefix + "_native", lib_path=lib)
        imgs = np.clip(np.random.default_rng(1).normal(0, 1, (8, SIZE, SIZE, 3)),
                       -2.117, 2.64).astype(np.float32)
        per_image = {b: host_ms(lambda b=b: nm.forward(imgs[:b])) / b for b in (1, 8)}
        # without OpenMP (a compiler that has none) the runtime runs on one thread
        threads = int(nm._lib.omp_get_max_threads()) if native.openmp() else 1
        nm.close()
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    cpu = cpu_model()
    cxx, flags = native.toolchain()
    print(f"deployment: libdfqrt built in {build_s:.2f} s ({cxx} {' '.join(flags)}); "
          f"convert --validate top-1 agreement {out['top1_agreement']}, max abs "
          f"{out['max_abs']}; native vs card mean {d.mean():.3g} max {d.max():.3g} within "
          f"5e-3 {within}; golden/ through the runtime max abs {golden_diff}; exports "
          f"byte-identical; native ms/image b1 {per_image[1]:.3f}, b8 {per_image[8]:.3f} "
          f"({threads} OpenMP threads, host CPU {cpu})", flush=True)
    return {"build_s": build_s, "golden_max_abs": golden_diff,
            "convert_max_abs": out["max_abs"], "native_vs_card": {
                "mean": float(d.mean()), "max": float(d.max()), "within_5e-3": within},
            "native_ms_per_image": per_image, "omp_threads": threads, "cpu": cpu,
            "compiler": cxx, "flags": list(flags)}


# the cold start of phase 16, run in a fresh interpreter: with AOT=1 the
# artifact's shipped kernels (nvcc made unreachable), else an nvcc build
# into an empty directory; prints one JSON line
COLD_START = r"""
import json, sys, tempfile, time
t0 = float(sys.argv[1])
from pathlib import Path
import numpy as np, torch
from dfq_tpu_torch.ops import _build
from dfq_tpu_torch.ops import conv_epilogue as cep
from dfq_tpu_torch.ops import cuda_int8 as ck
_build.BUILD_DIR = Path(tempfile.mkdtemp(dir=sys.argv[5]))
if sys.argv[2] == "1":
    def _no_nvcc():
        raise RuntimeError("nvcc reached in an AOT cold start")
    _build.nvcc_path = _no_nvcc
    from dfq_tpu_torch.io.aot import load_aot_forward
    net = load_aot_forward(sys.argv[3])
else:
    from dfq_tpu_torch.engine import Int8FusedNet
    from dfq_tpu_torch.io import load_artifact
    model, residual = load_artifact(sys.argv[3])
    net = Int8FusedNet(model, params_f32=residual)
x = torch.from_numpy(np.load(sys.argv[4])).cuda()
ck.reset_counts()
cep.reset_counts()
with torch.no_grad():
    y = net(x).cpu().numpy()
first = time.time() - t0
np.save(sys.argv[4] + ".out.npy", y)
print(json.dumps({"first_logits_s": first, "launches": dict(ck.LAUNCHES),
                  "epilogue_launches": cep.EPILOGUE_LAUNCHES,
                  "built": sorted(p.name for p in _build.BUILD_DIR.glob("*.so"))}))
"""


def phase_aot(root: Path) -> dict:
    """16. ``run_cls --aot-batch 128`` in-process, then a fresh process that
    cannot reach ``nvcc`` loads the payload and runs batch 128: its logits
    bit-equal to the exporting process's; the same from a process that
    builds with ``nvcc`` into an empty directory; a changed meta field
    refused."""
    import shutil

    import torch

    from dfq_tpu_torch.cli import run_cls
    from dfq_tpu_torch.io import aot
    from dfq_tpu_torch.ops import _build

    work = root / "build" / "aot_smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    art = work / "art"
    try:
        out = run_cls.main(["--quantize", "--relu", "--equalize", "--engine", "fused",
                            "--save-artifact", str(art), "--aot-batch", str(BIG_BATCH)])
        x = np.clip(np.random.default_rng(2).normal(0, 1, (BIG_BATCH, SIZE, SIZE, 3)),
                    -2.117, 2.64).astype(np.float32)
        np.save(work / "x.npy", x)
        with torch.no_grad():
            want = out["forward"](torch.from_numpy(x).to(DEVICE)).cpu().numpy()
        payload = sum(f.stat().st_size for f in (art / aot.AOT_DIR).iterdir())
        runs = {}
        for label, use_aot in (("aot", "1"), ("nvcc", "0")):
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-c", COLD_START, repr(t0), use_aot, str(art),
                 str(work / "x.npy"), str(work)],
                cwd=root, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"cold start ({label}) failed:\n{proc.stderr[-3000:]}")
            runs[label] = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[label]["wall_s"] = time.time() - t0
            got = np.load(str(work / "x.npy") + ".out.npy")
            if not np.array_equal(got, want):
                raise AssertionError(f"cold start ({label}): logits differ from the exporting "
                                     f"process's (max abs {float(np.abs(got - want).max())})")
        if runs["aot"]["built"]:
            raise AssertionError(f"the AOT cold start built {runs['aot']['built']}")
        if len(runs["nvcc"]["built"]) != len(_build.SOURCES):
            raise AssertionError(f"the nvcc cold start built {runs['nvcc']['built']}")
        if runs["aot"]["launches"] != {"matmul_int8_requant": 11, "dw3x3_int8_requant": 5,
                                       "fused_block_int8": 12}:
            raise AssertionError(f"AOT forward launches {runs['aot']['launches']}")
        for label, run in runs.items():
            if run["epilogue_launches"] != EPILOGUE_PINS["mobilenet_v2"]:
                raise AssertionError(f"{label} cold start: conv epilogue launches "
                                     f"{run['epilogue_launches']}")
            EPILOGUE_SEEN[f"mobilenet_v2_aot_{label}"] = run["epilogue_launches"]
        # a payload made for another card is refused
        meta_file = art / aot.AOT_DIR / "meta.json"
        meta = json.loads(meta_file.read_text())
        meta_file.write_text(json.dumps(dict(meta, device_name=meta["device_name"] + " (other)")))
        try:
            aot.load_aot_forward(str(art))
        except ValueError as e:
            if "re-export on matching hardware" not in str(e):
                raise
            refused = str(e)
        else:
            raise AssertionError("load_aot_forward took a payload of another card")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"aot: run_cls --aot-batch {BIG_BATCH} payload {payload} bytes (nvcc {meta['nvcc_release']}"
          f", torch {meta['torch_version']}, CUDA {meta['torch_cuda']}); fresh process to "
          f"first b{BIG_BATCH} logits: {runs['aot']['first_logits_s']:.2f} s from the shipped "
          f"kernels (nvcc unreachable), {runs['nvcc']['first_logits_s']:.2f} s building with "
          f"nvcc into an empty directory; both bit-equal to the exporting process; launches "
          f"{runs['aot']['launches']}; a changed device_name refused: {refused}", flush=True)
    return {"payload_bytes": payload, "meta": meta, "runs": runs,
            "launches": runs["aot"]["launches"], "refused": refused}


# phase 17's models: builder, input size, batch, detection flags, data-free
# ranges (else calibrated on two seeded batches), and the kernel sites of
# the JAX fused engine's forward (its pallas_call counts: K1, K2, K3)
ZOO = {
    "deeplab_xception": ("deeplab_xception", SEG_SIZE, SEG_BATCH, False, True, (69, 0, 0)),
    "deeplab_drn": ("deeplab_drn", SEG_SIZE, SEG_BATCH, False, True, (39, 0, 0)),
    "deeplab_resnet101": ("deeplab_resnet101", SEG_SIZE, SEG_BATCH, False, True, (73, 0, 0)),
    "mobilenet_v1_ssd": ("mobilenet_v1_ssd", SSD_SIZE, BATCH, True, False, (5, 3, 6)),
    "mobilenet_v1_ssd_lite": ("mobilenet_v1_ssd_lite", SSD_SIZE, BATCH, True, False, (21, 13, 6)),
    "squeezenet_ssd_lite": ("squeezenet_ssd_lite", SSD_SIZE, BATCH, True, False, (38, 10, 0)),
    "fpn_mobilenet_v1_ssd": ("fpn_mobilenet_v1_ssd", SSD_SIZE, BATCH, True, False, (7, 3, 6)),
    "vgg16_ssd": ("vgg16_ssd", SSD_SIZE, BATCH, True, False, (5, 0, 0)),
    "alexnet": ("alexnet", SIZE, BATCH, False, False, (3, 0, 0)),
}
ZOO_PRIORS = {"mobilenet_v1_ssd": 3000, "mobilenet_v1_ssd_lite": 3000,
              "squeezenet_ssd_lite": 2568, "fpn_mobilenet_v1_ssd": 3000, "vgg16_ssd": 8732}


def stride2_dw_sites(model) -> int:
    """The lowered 3x3 depthwise convs of stride 2 and padding 1, read from
    the graph: K2 takes them beside the JAX routing's sites (JAX runs them
    as XLA convs)."""
    return sum(1 for n in model.graph if n.op == "conv" and n.name in model.layers
               and n.attrs["kernel"] == (3, 3)
               and n.attrs["groups"] == n.attrs["in_ch"] == n.attrs["out_ch"]
               and n.attrs["stride"] == (2, 2) and n.attrs["padding"] == (1, 1)
               and n.attrs["dilation"] == (1, 1))


def zoo_model(name):
    """``(prepared, lowered, residual f32 params, input images)`` of a zoo
    model with random weights from the seed: the flagship config where the
    data-free ranges take the graph, else ``--relu --equalize`` with
    ranges from ``calibrate_ranges`` on the card over two seeded batches
    of 4 (the BN-less SSD variants and AlexNet, which the data-free range
    setter refuses as the reference does)."""
    import dfq_tpu_torch.models as models
    from dfq_tpu_torch.calib import calibrate_ranges
    from dfq_tpu_torch.engine import lower_int8
    from dfq_tpu_torch.models import init_params
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    fn, size, batch, det, data_free, _ = ZOO[name]
    build = getattr(models, fn)
    graph = build(input_size=size) if fn.startswith("deeplab") else build()
    flags = DET if det else {}
    rng = np.random.default_rng(0)
    if det:
        images = rng.uniform(-1, 1, (batch + 8, size, size, 3)).astype(np.float32)
    else:
        images = np.clip(rng.normal(0, 1, (batch + 8, size, size, 3)), -2.117,
                         2.64).astype(np.float32)
    params = init_params(graph, seed=0, bn_stats="random")
    if data_free:
        cfg = QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                          correction=True, bits_bias=16, **flags)
        prep = prepare(graph, params, cfg)
    else:
        cfg = QuantConfig(quantize=True, relu=True, equalize=True, bits_bias=16,
                          distill_range=True, **flags)
        prep = prepare(graph, params, cfg)
        prep.act_ranges = calibrate_ranges(
            prep.graph, prep.params, [images[batch:batch + 4], images[batch + 4:]],
            is_detection=det, device=DEVICE)
    model = lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model.layers}
    return prep, model, residual, images[:batch]


def phase_zoo(ck, wrappers, max_err: dict, gen, peaks) -> dict:
    """17. The rest of the model zoo at full width: each model's kernel
    sites and launches equal to the JAX fused engine's routing, every site
    bit-equal to its plain version at the model's batch and at batch 3, the
    fused forward bit-equal to its plain-kernel net, the baseline engine on
    the card against the CPU, every other int8 product against float64 at
    batch 2, the forward's time and peak memory, every site's time, and
    the former dp4a sites beside the dp4a variant at two batches."""
    import torch

    from dfq_tpu_torch.engine import Int8FusedNet, Int8Net

    result, sites, former = {}, [], []
    for name, (_, size, batch, det, data_free, jax_sites) in ZOO.items():
        t0 = time.perf_counter()
        prep, model, residual, images = zoo_model(name)
        prep_s = time.perf_counter() - t0
        graph = model.graph
        net = Int8FusedNet(model, device=DEVICE, params_f32=residual)
        ref_net = Int8FusedNet(model, device=DEVICE, plain_kernels=True, params_f32=residual)
        base = Int8Net(model, residual, device=DEVICE)
        want = dict(zip(wrappers, jax_sites))
        want["dw3x3_int8_requant"] += stride2_dw_sites(model)
        kinds = {k: sum(1 for _, kk, _ in net.kernel_sites if kk == k) for k in wrappers}
        if kinds != want:
            raise AssertionError(f"{name} kernel sites {kinds}, the JAX routing {want}")
        checks = [(s, b) for b in (batch, ODD_BATCH) for s in net.kernel_sites]
        hold_sites(graph, size, checks, wrappers, max_err, gen)
        x = torch.from_numpy(images).to(DEVICE)
        out, launches, variants = launch_forward(ck, net, x)
        EPILOGUE_SEEN[name] = epilogue_launches(name, net, batch)
        if launches != want:
            raise AssertionError(f"{name} launches {launches}, the JAX routing {want}")
        if ck.PLAIN_CALLS != dict.fromkeys(wrappers, 0):
            raise AssertionError(f"plain versions ran through the wrappers: {ck.PLAIN_CALLS}")
        with torch.no_grad():
            equal_outputs(f"{name} vs plain versions", out, ref_net(x))
        outs = out if isinstance(out, tuple) else (out,)
        if det:
            n = ZOO_PRIORS[name]
            shapes = [(batch, n, 21), (batch, n, 4)]
        elif name == "alexnet":
            shapes = [(batch, 1000)]
        else:
            shapes = [(batch, size, size, 21)]
        if [tuple(o.shape) for o in outs] != shapes or not all(
                torch.isfinite(o).all() for o in outs):
            raise AssertionError(f"{name} outputs {[tuple(o.shape) for o in outs]}")
        if det:
            sums = float((outs[0].sum(-1) - 1).abs().max())
            if sums > 1e-4:
                raise AssertionError(f"{name} confidences sum to 1 within {sums}")
        card_cpu = hold_engines_card_vs_cpu(name, model, residual,
                                            x[:1] if size == SEG_SIZE else x[:2], ENGINE_RTOL)
        exact = phase_exact_products(
            [(name, graph, [("baseline", base), ("fused", net)], size, (2, None, None))], gen)
        ms, peak = forward_peak(net, x)
        for node, kernel, op in net.kernel_sites:
            xs = site_input(graph, size, kernel, node, batch, gen)
            t = time_site(kernel, op, xs, wrappers, peaks, reps=10, rounds=3)
            t.update(path=name, batch=batch, node=node)
            sites.append(t)
            del xs
        for b in (batch, BATCH if size == SEG_SIZE else BIG_BATCH):
            for node, kernel, op in net.kernel_sites:
                if kernel == "matmul_int8_requant" and former_dp4a(ck, op):
                    xs = site_input(graph, size, kernel, node, b, gen)
                    former.append(time_former_dp4a(ck, wrappers, peaks, name, b, node, op, xs))
                    del xs
        mine = [t for t in sites if t["path"] == name]
        by_kernel = {k: {"sites": len(ks), "device_ms": sum(t["device_ms"] for t in ks),
                         "ms": sum(t["ms"] for t in ks), "bound_ms": sum(t["bound_ms"] for t in ks),
                         "plain_ms": sum(t["plain_ms"] for t in ks),
                         "library_device_ms": sum(t["library_device_ms"] or 0.0 for t in ks)}
                     for k in wrappers if (ks := [t for t in mine if t["kernel"] == k])}
        result[name] = {"launches": launches, "epilogue_launches": EPILOGUE_SEEN[name],
                        "variants": variants, "card_vs_cpu": card_cpu,
                        "exact_products": exact["checks"], "forward_ms": ms, "peak_bytes": peak,
                        "batch": batch, "size": size, "prepare_s": prep_s,
                        "ranges": "data-free" if data_free else "calibrated",
                        "kernels": by_kernel}
        print(f"zoo {name} {size}x{size} b{batch} ({result[name]['ranges']} ranges, prepared in "
              f"{prep_s:.1f} s): sites == JAX routing {launches}, variants {variants}; every "
              f"site bit-equal to plain at b{batch} and b{ODD_BATCH}; forward bit-equal to the "
              f"plain-kernel net; baseline card vs CPU {card_cpu}; {exact['checks']} exact "
              f"products bit-equal to float64 at b2; fused forward {ms:.3f} ms "
              f"({batch / ms * 1e3:.1f} img/s), peak {peak / 2**30:.3f} GiB; kernels "
              f"{by_kernel}", flush=True)
        del prep, model, residual, net, ref_net, base, out, outs, x
        torch.cuda.empty_cache()
    print_sites(sites)
    return {"models": result, "sites": sites, "former_dp4a": former}


# phase 18: the global batch of the data-parallel forwards, the shard counts
# of its meshes on the one card, and the host batches of the stream
PAR_BATCH = 128
PAR_SHARDS = (4, 3)  # b32 each; uneven 43 / 43 / 42
PAR_SITE_BATCHES = (32, 42)
STREAM_BATCHES = 6
SEG_SHARDS = 2
DIS_SHARDS = 4
# the sharded distillation step against the single-device step: the loss,
# relative; the gradient, of its largest magnitude, to phase 14's limit; the
# images after the step, of their largest magnitude, to the same limit at
# every pixel whose single-device gradient is above PAR_X1_G_FLOOR (see
# phase_parallel). Adam's first step moves a pixel by lr * g / (|g| + eps),
# so a gradient error dg moves it by about lr * eps * dg / |g|^2: at the
# gradient's limit (1e-4 of its max, 6.4e-4 at this seed) and |g| = 1e-6
# that is 6.4e-5, under the images' limit (1e-4 of their max, 2.6e-4)
PAR_LOSS_RTOL = 1e-5
PAR_X1_RTOL = DIS_GRAD_RTOL
ADAM_B1, ADAM_EPS = 0.9, 1e-8
PAR_X1_G_FLOOR = 1e2 * ADAM_EPS
TP_MESH = (2, 2)
MULTIBOX_BATCH = 32
MULTIBOX_RTOL = 1e-5


def sync_warnings(fn) -> list:
    """The host synchronisations ``fn()`` makes, one entry each, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them (a sync would
    serialise the stream's pipeline; the mode's notice that it is a
    prototype is left out)."""
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return [str(w.message).splitlines()[0] for w in caught
            if "called a synchronizing" in str(w.message)]


def phase_parallel(ck, wrappers, max_err: dict, gen, main_path: dict, seg_path: dict) -> dict:
    """18. ``dfq_tpu_torch.parallel`` at full width on the card: the
    data-parallel fused forward and eval of MobileNetV2 224x224 at b128 on
    1, 4 and 3 shards (bit-equal to the single forward, 11 / 5 / 12
    launches a shard, every kernel site bit-equal to its plain version at
    the shard batches), the stream against the synchronous loop, DeepLab's
    sharded confusion matrix, the sharded distillation step, the
    tensor-parallel baseline engine, a one-process NCCL group's reductions
    and ``multibox_loss`` on the card against the CPU."""
    import socket

    import torch
    import torch.distributed as dist

    from dfq_tpu_torch.calib.distill import (
        AdamState,
        DistillConfig,
        adam_step,
        init_random_batch,
        loss_and_grad,
        make_loss_fn,
    )
    from dfq_tpu_torch.detection.losses import MatchPrior, hard_negative_mining, multibox_loss
    from dfq_tpu_torch.engine import Int8Net
    from dfq_tpu_torch.metrics import SegEvaluator
    from dfq_tpu_torch.models.ssd import SSDConfig
    from dfq_tpu_torch.parallel import (
        data_mesh,
        make_sharded_distill_step,
        make_sharded_eval,
        make_sharded_forward,
        make_sharded_seg_eval,
        make_streaming_eval,
        make_tp_int8_forward,
        tp_mesh,
    )
    from dfq_tpu_torch.ops import conv_epilogue as cep
    from dfq_tpu_torch.parallel import multihost
    from dfq_tpu_torch.parallel.eval import count_correct

    detail, launches_by_path = {}, {}
    model, residual, net = main_path["model"], main_path["residual"], main_path["net"]
    graph = model.graph
    per_shard = {"matmul_int8_requant": 11, "dw3x3_int8_requant": 5, "fused_block_int8": 12}
    card = data_mesh().devices[0]  # the card, as a mesh names it
    smi = nvidia_smi_line()

    # 1. the data-parallel fused forward and eval
    hold_sites(graph, SIZE, [(s, b) for b in PAR_SITE_BATCHES for s in net.kernel_sites],
               wrappers, max_err, gen)
    rng = np.random.default_rng(18)
    x_host = np.clip(rng.standard_normal((PAR_BATCH, SIZE, SIZE, 3), np.float32), -2.117, 2.64)
    x = torch.from_numpy(x_host).to(DEVICE)
    with torch.no_grad():
        single = net(x)
    pred = single.argmax(-1).cpu().numpy()
    labels = np.where(np.arange(PAR_BATCH) % 2 == 0, pred, (pred + 1) % 1000)
    want_counts = (int((pred == labels).sum()), PAR_BATCH)
    meshes = {f"mobilenet_v2_sharded_{n}": data_mesh(devices=[card] * n) for n in PAR_SHARDS}
    meshes = {"mobilenet_v2_data_mesh": data_mesh(), **meshes}
    dp = {}
    for path, mesh in meshes.items():
        fwd = make_sharded_forward(None, residual, mesh, int8_model=model, engine="fused")
        # a new replica: its first call runs step by step, captures and
        # replays; the third only replays, and its trace counts the kernels
        ck.reset_counts()
        cep.reset_counts()
        with torch.no_grad():
            first = fwd(x)
        out, launches, variants, epilogue = replayed_kernels(lambda: fwd(x))
        k1_on_tensor_cores(path, variants)
        n = mesh.size
        if launches != {k: v * n for k, v in per_shard.items()}:
            raise AssertionError(f"{path}: traced kernel calls {launches} over {n} shards")
        EPILOGUE_SEEN[path] = epilogue
        if (epilogue, cep.EPILOGUE_PLAIN_CALLS) != (EPILOGUE_PINS["mobilenet_v2"] * n, 0):
            raise AssertionError(f"{path}: traced conv epilogue calls and plain runs "
                                 f"{(epilogue, cep.EPILOGUE_PLAIN_CALLS)} over {n} shards")
        if ck.PLAIN_CALLS != dict.fromkeys(wrappers, 0):
            raise AssertionError(f"plain versions ran through the wrappers: {ck.PLAIN_CALLS}")
        equal_outputs(f"{path} vs the single forward", first.gather(), single)
        equal_outputs(f"{path} replayed vs the single forward", out.gather(), single)
        counts = make_sharded_eval(None, residual, mesh, int8_model=model,
                                   engine="fused")(x, labels)
        if counts != want_counts:
            raise AssertionError(f"{path}: counters {counts}, single forward {want_counts}")
        ms = forward_ms(fwd, x)
        launches_by_path[path] = launches
        dp[path] = {"shards": [int(s.shape[0]) for s in out.shards], "launches": launches,
                    "variants": variants, "counts": counts, "forward_ms": ms}
        print(f"{path}: shards {dp[path]['shards']}, logits bit-equal to the single b"
              f"{PAR_BATCH} forward, counters {counts}, launches {launches}, variants "
              f"{variants}; forward {ms:.3f} ms ({PAR_BATCH / ms * 1e3:.0f} img/s) on {smi}",
              flush=True)
    # the single forward at the global batch and at each shard's batch
    single_ms = {b: forward_ms(net, x[:b]) for b in (PAR_BATCH, 43, 42, 32)}
    print(f"single forward ms by batch {single_ms} on {smi}; every kernel site bit-equal to "
          f"its plain version at b{PAR_SITE_BATCHES}", flush=True)
    detail["data_parallel"] = dp
    detail["single_forward_ms"] = single_ms

    # 2. the stream against the synchronous loop
    batches = [(np.clip(rng.standard_normal((PAR_BATCH, SIZE, SIZE, 3), np.float32),
                        -2.117, 2.64), rng.integers(0, 1000, PAR_BATCH))
               for _ in range(STREAM_BATCHES)]
    batches[0] = (x_host, labels)
    mesh1 = data_mesh()
    sync_run = make_sharded_eval(None, residual, mesh1, int8_model=model, engine="fused")
    stream_run = make_streaming_eval(None, residual, mesh1, int8_model=model, engine="fused")

    def sync_loop():
        got = [sync_run(xb, lb) for xb, lb in batches]
        return sum(c for c, _ in got), sum(t for _, t in got)

    sync_loop(), stream_run(iter(batches))  # warm-up: the pinned host blocks
    times = {}
    for name, fn in (("sync", sync_loop), ("stream", lambda: stream_run(iter(batches)))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        times[name] = (time.perf_counter() - t0) * 1e3 / STREAM_BATCHES
        detail[f"{name}_counts"] = result
    if detail["sync_counts"] != detail["stream_counts"]:
        raise AssertionError(f"stream counters {detail['stream_counts']} != sync "
                             f"{detail['sync_counts']}")
    with torch.no_grad():
        syncs = sync_warnings(lambda: net(x))
    # a stream of n batches reads its n counters: n syncs, and no more
    stream_syncs = sync_warnings(lambda: stream_run(iter(batches[:3])))
    detail["stream_ms_per_batch"] = times
    detail["forward_host_syncs"] = syncs
    detail["stream_host_syncs_3_batches"] = stream_syncs
    print(f"stream (depth 2) vs sync over {STREAM_BATCHES} host batches of b{PAR_BATCH}: "
          f"counters {detail['stream_counts']} equal; ms a batch: sync {times['sync']:.3f}, "
          f"stream {times['stream']:.3f}; host syncs in the fused forward: {syncs or 'none'}; "
          f"in a stream of 3 batches: {len(stream_syncs)} {sorted(set(stream_syncs))}",
          flush=True)
    del batches

    # 3. DeepLab's sharded confusion matrix
    seg_model, seg_net = seg_path["model"], seg_path["net"]
    seg_residual = {k: v for k, v in seg_path["prep"].params.items()
                    if k not in seg_model.layers}
    xs = torch.from_numpy(seg_path["images"][:SEG_BATCH]).to(DEVICE)
    gt = rng.integers(0, 21, (SEG_BATCH, SEG_SIZE, SEG_SIZE))
    gt[rng.random(gt.shape) < 0.1] = 255
    with torch.no_grad():
        seg_pred = seg_net(xs).argmax(-1).cpu().numpy()
    ev = SegEvaluator(21)
    ev.add_batch(gt, seg_pred)
    seg_mesh = data_mesh(devices=[card] * SEG_SHARDS)
    seg_eval = make_sharded_seg_eval(None, seg_residual, seg_mesh, 21, int8_model=seg_model,
                                     engine="fused")
    ck.reset_counts()
    cep.reset_counts()
    conf = seg_eval(xs, gt)
    again, seg_launches, _, epilogue = replayed_kernels(lambda: seg_eval(xs, gt))
    launches_by_path[f"deeplab_mnv2_sharded_{SEG_SHARDS}"] = seg_launches
    EPILOGUE_SEEN[f"deeplab_mnv2_sharded_{SEG_SHARDS}"] = epilogue
    if (epilogue, cep.EPILOGUE_PLAIN_CALLS) != (EPILOGUE_PINS["deeplab_mnv2"] * SEG_SHARDS, 0):
        raise AssertionError(f"sharded DeepLab traced conv epilogue calls and plain runs "
                             f"{(epilogue, cep.EPILOGUE_PLAIN_CALLS)}")
    if seg_launches != {"matmul_int8_requant": 38 * SEG_SHARDS, "dw3x3_int8_requant": 0,
                        "fused_block_int8": 0}:
        raise AssertionError(f"sharded DeepLab traced kernel calls {seg_launches}")
    if not np.array_equal(conf, ev.confusion_matrix) or not np.array_equal(again, conf):
        raise AssertionError("sharded DeepLab confusion matrix != SegEvaluator's on the single "
                             "forward")
    detail["seg_confusion_sum"] = int(conf.sum())
    print(f"DeepLab {SEG_SIZE}x{SEG_SIZE} b{SEG_BATCH} on {SEG_SHARDS} shards: confusion matrix equal to "
          f"SegEvaluator's on the single forward ({int(conf.sum())} valid pixels), launches "
          f"{launches_by_path[f'deeplab_mnv2_sharded_{SEG_SHARDS}']}", flush=True)
    del xs

    # 4. the sharded distillation step against the single-device step
    prep = main_path["prep"]
    cfg = DistillConfig(batch_size=DIS_BATCH, compute_dtype="f32", device=DEVICE)
    x0 = init_random_batch(np.random.default_rng(0), cfg)
    loss_fn, _ = make_loss_fn(prep.graph, prep.params_fp, cfg)
    x0_t = torch.from_numpy(x0).to(DEVICE)

    def single_step():
        st = AdamState.init(x0_t, cfg.lr, injected=False)
        loss, grad = loss_and_grad(loss_fn, x0_t)
        with torch.no_grad():
            return adam_step(x0_t, grad, st), loss, st

    step, init = make_sharded_distill_step(prep.graph, prep.params_fp, cfg,
                                           data_mesh(devices=[card] * DIS_SHARDS))

    def sharded_step():
        xd, st = init(x0_t)
        x1, st, loss = step(xd, st)
        return x1, loss, st

    x1_single, loss_single, st_single = single_step()
    x1_sharded, loss_sharded, st_sharded = sharded_step()
    x1_sharded = x1_sharded.gather()
    # the gradients the two steps took, read from their own Adam states:
    # after the first step from zero moments, mu = (1 - b1) g, rounded once
    # (the backward's convs are not bit-reproducible on the card, so a
    # gradient derived again here would not be the one a step took)
    mu_single = st_single.mu
    mu_sharded = torch.cat([st.mu for st in st_sharded])
    loss_rel = abs(float(loss_sharded) - float(loss_single)) / abs(float(loss_single))
    grad_rel = float((mu_sharded - mu_single).abs().max() / mu_single.abs().max())
    # where |g| is near eps, a last-bit gradient difference (the shards'
    # convs run at another batch) moves a pixel by up to 2 lr: the images
    # are held where |g| > PAR_X1_G_FLOOR, and the pixels over the limit,
    # with the largest |g| among them, show the cause
    dx1 = (x1_sharded - x1_single).abs()
    x1_limit = PAR_X1_RTOL * float(x1_single.abs().max())
    g_abs = mu_single.abs() / (1.0 - ADAM_B1)
    held = g_abs > PAR_X1_G_FLOOR
    over = dx1 > x1_limit
    x1_rel_held = float(dx1[held].max()) / float(x1_single.abs().max())
    x1_rel = float(dx1.max()) / float(x1_single.abs().max())
    n_low = int((~held).sum())
    n_over = int(over.sum())
    g_over = float(g_abs[over].max()) if n_over else None
    ms_single = host_ms(lambda: (single_step(), torch.cuda.synchronize()))
    ms_sharded = host_ms(lambda: (sharded_step(), torch.cuda.synchronize()))
    detail["distill"] = {"batch": DIS_BATCH, "shards": DIS_SHARDS, "loss_rel": loss_rel,
                         "grad_rel_of_max": grad_rel, "grad_max_abs": float(g_abs.max()),
                         "x1_rel_of_max": x1_rel, "x1_rel_of_max_held": x1_rel_held,
                         "pixels": int(dx1.numel()), "pixels_below_g_floor": n_low,
                         "pixels_over_limit": n_over, "max_abs_g_over_limit": g_over,
                         "ms_per_step_single": ms_single, "ms_per_step_sharded": ms_sharded}
    if loss_rel > PAR_LOSS_RTOL or grad_rel > DIS_GRAD_RTOL or x1_rel_held > PAR_X1_RTOL:
        raise AssertionError(f"sharded distill step: loss rel {loss_rel} (limit "
                             f"{PAR_LOSS_RTOL}), gradient {grad_rel} of its max (limit "
                             f"{DIS_GRAD_RTOL}), x1 {x1_rel_held} of its max where |g| > "
                             f"{PAR_X1_G_FLOOR} (limit {PAR_X1_RTOL}); {n_over} pixels over "
                             f"the limit, the largest |g| among them {g_over}")
    print(f"distill MobileNetV2 {SIZE}x{SIZE} b{DIS_BATCH} f32, {DIS_SHARDS} shards vs one: "
          f"loss rel {loss_rel:.2e}, the steps' own gradients {grad_rel:.2e} of their max "
          f"({float(g_abs.max()):.3e}), x1 {x1_rel_held:.2e} of its max where |g| > "
          f"{PAR_X1_G_FLOOR:.0e} (limit {PAR_X1_RTOL}; "
          f"{n_low} of {dx1.numel()} pixels at or below it), {x1_rel:.2e} at all; "
          f"{n_over} pixels over the limit, the largest |g| among them {g_over}; ms a step "
          f"{ms_single:.3f} single, {ms_sharded:.3f} sharded", flush=True)
    del x0_t, x1_single, x1_sharded

    # 5. tensor parallel: the baseline engine, weights split on the output channel
    x8 = x[:BATCH]
    tp = make_tp_int8_forward(model, residual, tp_mesh(*TP_MESH, devices=[card] * 4))
    with torch.no_grad():
        ck.reset_counts()
        tp_out = tp(x8).gather()
        torch.cuda.synchronize()
        tp_launches = dict(ck.LAUNCHES)
        base = Int8Net(model, residual, device=DEVICE)(x8)
    tp_err = float((tp_out - base).abs().max())
    peak = float(base.abs().max())
    if tp_err > TOL * peak or not torch.equal(tp_out.argmax(-1), base.argmax(-1)):
        raise AssertionError(f"tensor parallel vs Int8Net: max abs {tp_err} of max {peak}")
    launches_by_path[f"mobilenet_v2_tp_{TP_MESH[0]}x{TP_MESH[1]}"] = tp_launches
    tp_ms = forward_ms(tp, x8)
    detail["tensor_parallel"] = {"mesh": TP_MESH, "max_abs": tp_err, "max_logit": peak,
                                 "launches": tp_launches, "forward_ms": tp_ms}
    print(f"tensor parallel {TP_MESH[0]}x{TP_MESH[1]} b{BATCH}: max abs vs Int8Net {tp_err} "
          f"(limit {TOL} of {peak:.4f}), argmax equal, kernel launches {tp_launches}; forward "
          f"{tp_ms:.3f} ms", flush=True)

    # 6. a one-process NCCL group: the reductions equal the local values
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    multihost.initialize(f"localhost:{port}", 1, 0, device=DEVICE)
    try:
        if dist.get_backend() != ("nccl" if DEVICE == "cuda" else "gloo") or \
                multihost.process_count() != 1:
            raise AssertionError(f"process group {dist.get_backend()}, "
                                 f"{multihost.process_count()} processes")
        mesh1 = multihost.global_mesh()
        local = rng.standard_normal((8, 3)).astype(np.float32)
        arr = multihost.make_global_batch(mesh1, local)
        got_sum = float(arr.sum())
        want_sum = float(torch.from_numpy(local).to(DEVICE).sum())
        lg = multihost.make_global_batch(mesh1, single[:BATCH].cpu().numpy())
        lb = multihost.make_global_batch(mesh1, labels[:BATCH])
        got_counts = count_correct(lg, lb).tolist()
    finally:
        dist.destroy_process_group()
    want_local = [int((pred[:BATCH] == labels[:BATCH]).sum()), BATCH]
    if got_sum != want_sum or got_counts != want_local or arr.shape != (8, 3):
        raise AssertionError(f"NCCL world 1: sum {got_sum} vs {want_sum}, counters "
                             f"{got_counts} vs {want_local}, shape {arr.shape}")
    detail["nccl_world_1"] = {"sum": got_sum, "counts": got_counts}
    print(f"NCCL group of one: all_reduce sum {got_sum} and counters {got_counts} equal the "
          f"local ones", flush=True)

    # 7. multibox_loss on the card against the CPU at SSD-Lite's priors
    sc = SSDConfig()
    match = MatchPrior(sc.priors, sc.center_variance, sc.size_variance, sc.iou_threshold)
    locs, labs = [], []
    for _ in range(MULTIBOX_BATCH):
        lo = rng.uniform(0.0, 0.6, (3, 2))
        boxes = np.concatenate([lo, lo + rng.uniform(0.1, 0.4, (3, 2))], 1).astype(np.float32)
        loc, lab = match(np.clip(boxes, 0.0, 1.0), rng.integers(1, 21, 3))
        locs.append(loc)
        labs.append(lab)
    inputs = (rng.standard_normal((MULTIBOX_BATCH, 3000, 21)).astype(np.float32),
              rng.standard_normal((MULTIBOX_BATCH, 3000, 4)).astype(np.float32),
              np.stack(labs).astype(np.int64), np.stack(locs))
    res = {}
    for dev in (DEVICE, "cpu"):
        t = [torch.from_numpy(a).to(dev) for a in inputs]
        mask = hard_negative_mining(-torch.log_softmax(t[0], 2)[..., 0], t[2], 3)
        res[dev] = ([float(v) for v in multibox_loss(*t)], mask.cpu().numpy())
    (l_card, m_card), (l_cpu, m_cpu) = res[DEVICE], res["cpu"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_card, l_cpu))
    if not np.array_equal(m_card, m_cpu) or rel > MULTIBOX_RTOL:
        raise AssertionError(f"multibox_loss card vs CPU: {l_card} vs {l_cpu} (rel {rel}), "
                             f"masks differ at {int((m_card != m_cpu).sum())}")
    detail["multibox"] = {"card": l_card, "cpu": l_cpu, "rel": rel,
                          "mask_kept": int(m_card.sum())}
    print(f"multibox_loss b{MULTIBOX_BATCH} x 3000 priors x 21: card {l_card} vs CPU {l_cpu} "
          f"(rel {rel:.2e}), masks equal ({int(m_card.sum())} kept)", flush=True)
    return {"detail": detail, "launches": launches_by_path}


# phase 19: the fused engine's lowering policies (its keyword options, the
# JAX engine's names and meanings, ``use_kernels`` for its ``use_pallas``),
# each against the default net; the paths and batches they run at; and the
# launches a forward makes under the kernel configurations, equal to the JAX
# fused engine's ``pallas_call`` counts under the same options (read from its
# trace by tests/test_torch_policies_configs.py) and, where the kernels run,
# K2 at the graph's stride-2 depthwise convs, which JAX runs as XLA convs.
# The conv policies move no kernel site: they launch as the default
POLICIES = {
    "stem_s2d": {"stem_s2d": True},
    "dense32_h160": {"dw_dense_max_ch": 32, "dw_dense_max_h": 160},
    "chpad_k3": {"chpad_k3": True},
    "im2col": {"k3_matmul": "im2col"},
    "shift9_all": {"k3_matmul": "shift9", "k3_matmul_min_ch": 0},
    "b2s56": {"b2s_min_h": 56},
    "unfused": {"fuse_blocks": False},
    "no_kernels": {"use_kernels": False},
    "no_kernels_unfused": {"use_kernels": False, "fuse_blocks": False},
}
# (K1, K2, K3) launches a forward, by path and kernel configuration
POLICY_LAUNCHES = {
    "mobilenet_v2": {"default": (11, 5, 12), "unfused": (35, 17, 0),
                     "no_kernels": (0, 0, 12), "no_kernels_unfused": (0, 0, 0)},
    "resnet18": {"default": (1, 0, 0), "unfused": (1, 0, 0),
                 "no_kernels": (0, 0, 0), "no_kernels_unfused": (0, 0, 0)},
    "ssd_lite": {"default": (30, 19, 12), "unfused": (54, 31, 0),
                 "no_kernels": (0, 0, 12), "no_kernels_unfused": (0, 0, 0)},
    "deeplab_mnv2": {"default": (38, 0, 0), "unfused": (38, 0, 0),
                     "no_kernels": (0, 0, 0), "no_kernels_unfused": (0, 0, 0)},
}
AUTOTUNE_ROUNDS = 5
# the classification images the kernel configurations are held on against
# the CPU: image 13 of the seed's 16 lands on a tie that K1/K2 and K3 round
# apart (the configurations part from the default there, in JAX too)
POLICY_CPU_ROWS = slice(12, 14)


def phase_graphs(ck, paths, gen) -> dict:
    """20. The fused forward as a CUDA graph (module docstring), on
    ``paths``: ``(path, model, residual f32 params, image size)``."""
    import torch

    from dfq_tpu_torch.engine import Int8FusedNet, int8_fused
    from dfq_tpu_torch.ops import conv_epilogue as cep

    def outs(o):
        return o if isinstance(o, tuple) else (o,)

    detail = {}
    for path, model, residual, size in paths:
        batch = EPILOGUE_CELL_BATCH[path]
        net = Int8FusedNet(model, device=DEVICE, params_f32=residual)
        xa, xb = (torch.randn(batch, size, size, 3, device=DEVICE, generator=gen)
                  for _ in range(2))
        with torch.no_grad():
            want_a, want_b = step_by_step(net, xa), step_by_step(net, xb)
            counts = dict(int8_fused.GRAPH_COUNTS)
            ck.reset_counts()
            cep.reset_counts()
            first = net(xa)
            torch.cuda.synchronize()
            eager = (dict(ck.LAUNCHES), cep.EPILOGUE_LAUNCHES)
            reserved = [torch.cuda.memory_reserved()]
            second = net(xb)
            torch.cuda.synchronize()
            reserved.append(torch.cuda.memory_reserved())
            third = net(xa)
            held = [o.clone() for o in outs(third)]
            fourth = net(xb)
            moved = {k: v - counts[k] for k, v in int8_fused.GRAPH_COUNTS.items()}
            if moved != {"captures": 1, "replays": 3, "eager": 1} or len(net._graphs) != 1:
                raise AssertionError(f"{path}: graph counters moved {moved}")
            low = net.lowering(batch)
            sites = ({k: sum(1 for _, kk, _ in low.kernel_sites if kk == k) for k in ck.LAUNCHES},
                     len(low.epilogue_sites))
            if eager != sites:
                raise AssertionError(f"{path}: the first forward launched {eager}, the "
                                     f"lowering has {sites}")
            fifth, traced, _, epilogue = replayed_kernels(lambda: net(xa))
            if (traced, epilogue) != sites:
                raise AssertionError(f"{path}: a replay's trace shows {traced} and {epilogue} "
                                     f"epilogue calls, the lowering has {sites}")
            for label, got, want in (("first", first, want_a), ("second", second, want_b),
                                     ("third", third, want_a), ("fourth", fourth, want_b),
                                     ("traced", fifth, want_a),
                                     ("held", tuple(held), outs(third))):
                for o, w in zip(outs(got), outs(want)):
                    equal_outputs(f"{path} b{batch} {label}", o, w)
            ms = {"step_by_step": time_ms(lambda: step_by_step(net, xa), reps=5, rounds=3),
                  "replayed": time_ms(lambda: net(xa), reps=5, rounds=3)}
            host = {}
            for label, fn in (("step_by_step", lambda: step_by_step(net, xa)),
                              ("replayed", lambda: net(xa))):
                per = []
                for _ in range(6):  # each call issued onto an idle device
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    per.append((time.perf_counter() - t0) * 1e3)
                host[label] = float(np.median(per[1:]))
            torch.cuda.synchronize()
        detail[path] = {"batch": batch, "ms": ms, "host_ms": host, "launches": eager[0],
                        "epilogue_launches": eager[1], "replay_traced": traced,
                        "replay_traced_epilogue": epilogue, "reserved_bytes": reserved}
        print(f"{path} b{batch} as a CUDA graph: replays bit-equal to the step-by-step "
              f"forward; a replay's trace shows {traced} and {epilogue} epilogue calls, one a "
              f"site of the lowering, as the first forward launched; ms a forward back to "
              f"back {ms}, host ms {host}; reserved {reserved[0] / 2**30:.3f} -> "
              f"{reserved[1] / 2**30:.3f} GiB at the capture", flush=True)
        del net, first, second, third, fourth, fifth, held, want_a, want_b
        torch.cuda.empty_cache()
    return detail


def phase_policies(ck, wrappers, max_err: dict, gen, paths, card: str) -> dict:
    """19. Every policy of ``POLICIES`` on each of ``paths`` (``(name, prep,
    model, default net, input size, batches, inputs, rows for the CPU)``):
    the launches per kernel as ``POLICY_LAUNCHES`` pins them; a conv
    policy's outputs bit-equal to the default net's (an exact rewrite); a
    kernel configuration that routes the requantizations anew (its K1 and
    K2 round a tie of the output scale's reciprocal as ``f32(1.0 / s)``, K3
    and the glue as ``f32(1 / f32(s))``, as the JAX engine's kernels do)
    bit-equal to the same configuration with the kernels' plain versions,
    and on the CPU rows within ``ENGINE_RTOL`` of itself on the CPU (where
    the tests hold it equal to JAX's), its difference from the default
    printed; every kernel site the default net does not have bit-equal to
    its plain version at the first batch (the others are the default's
    sites, held in phases 3, 8, 12 and 13); the forward's median ms and
    peak device memory beside the default's, read before and after them.
    Then ``autotune_dw_policy`` on
    MobileNetV2 and SSD-Lite at b8 with a cache in a temporary directory
    (the race, a hit, a truncated file raced again), and
    ``roofline_report`` of MobileNetV2 b128 beside its measured default
    forward."""
    import tempfile

    import torch

    from dfq_tpu_torch.engine import Int8FusedNet, autotune_dw_policy
    from dfq_tpu_torch.utils.profiling import device_peaks, roofline_report

    names = list(wrappers)
    rows, launches_by = [], {}
    fwd_ms = {}
    for name, prep, model, net, size, batches, inputs, cpu_rows in paths:
        residual = {k: v for k, v in prep.params.items() if k not in model.layers}
        default_sites = [(n, k) for n, k, _ in net.kernel_sites]
        has_blocks = POLICY_LAUNCHES[name]["default"][2] > 0
        for bi, batch in enumerate(batches):
            x = torch.from_numpy(np.resize(inputs, (batch,) + inputs.shape[1:])).to(DEVICE)
            want, base_launches, _ = launch_forward(ck, net, x)
            if tuple(base_launches[k] for k in names) != POLICY_LAUNCHES[name]["default"]:
                raise AssertionError(f"{name} b{batch} default launches {base_launches}")
            ms0, peak0 = forward_peak(net, x)
            fwd_ms[(name, batch)] = ms0
            print(f"policies: {name} b{batch} ({card}): default {ms0:.3f} ms, peak "
                  f"{peak0 / 2**30:.3f} GiB", flush=True)
            rows.append({"path": name, "batch": batch, "policy": "default", "ms": ms0,
                         "peak_bytes": peak0, "launches": base_launches})
            # the outputs of each routing of the requantizations: (kernels on,
            # blocks fused); fuse_blocks moves nothing on a path without blocks
            by_route = {(True, True): ("default", want)}
            for label, opts in POLICIES.items():
                pnet = Int8FusedNet(model, device=DEVICE, params_f32=residual, **opts)
                got, launches, _ = launch_forward(ck, pnet, x)
                expect = POLICY_LAUNCHES[name].get(label, POLICY_LAUNCHES[name]["default"])
                if tuple(launches[k] for k in names) != expect:
                    raise AssertionError(f"{name} b{batch} {label}: launches {launches}, "
                                         f"expected {expect}")
                launches_by[f"{name}/b{batch}/{label}"] = launches
                route = (opts.get("use_kernels", True),
                         opts.get("fuse_blocks", True) or not has_blocks)
                row = {"path": name, "batch": batch, "policy": label, "launches": launches}
                if route in by_route:
                    same, out = by_route[route]
                    equal_outputs(f"{name} b{batch} {label} vs the {same} net", got, out)
                    check = f"outputs == {same}"
                else:
                    by_route[route] = (label, got)
                    check = "a new routing"
                    if any(launches.values()):
                        plain_net = Int8FusedNet(model, device=DEVICE, params_f32=residual,
                                                 plain_kernels=True, **opts)
                        with torch.no_grad():
                            equal_outputs(f"{name} b{batch} {label} vs its plain versions",
                                          got, plain_net(x))
                        del plain_net
                        check += ", == its plain versions"
                    g_, w_ = (v if isinstance(v, tuple) else (v,) for v in (got, want))
                    d = max(float((a - b).abs().max()) for a, b in zip(g_, w_))
                    n_rows = int(sum((a != b).reshape(batch, -1).any(1) for a, b in zip(g_, w_)
                                     ).count_nonzero())
                    row.update(vs_default_max_abs=d, vs_default_rows=n_rows)
                    check += f", vs the default: max abs {d:.6g} in {n_rows} of {batch} images"
                    if bi == 0:
                        xr = torch.from_numpy(inputs[cpu_rows])
                        with torch.no_grad():
                            on_card = pnet(xr.to(DEVICE))
                            on_cpu = Int8FusedNet(model, device="cpu", params_f32=residual,
                                                  **opts)(xr)
                        c_, h_ = (v if isinstance(v, tuple) else (v,) for v in (on_card, on_cpu))
                        dc = max(float((a.cpu() - b).abs().max()) for a, b in zip(c_, h_))
                        top = max(float(b.abs().max()) for b in h_)
                        if not dc <= ENGINE_RTOL * top:
                            raise AssertionError(f"{name} {label}: card vs CPU max abs {dc} > "
                                                 f"{ENGINE_RTOL} x {top}")
                        row["card_vs_cpu_max_abs"] = dc
                        check += f"; card vs CPU at {xr.shape[0]} images: max abs {dc:.3g}"
                sites = [(n, k) for n, k, _ in pnet.kernel_sites]
                if label not in POLICY_LAUNCHES[name] and sites != default_sites:
                    raise AssertionError(f"{name} {label}: kernel sites moved")
                new = [s for s in pnet.kernel_sites if (s[0], s[1]) not in default_sites]
                if bi == 0 and new:
                    hold_sites(model.graph, size, [(s, batch) for s in new], wrappers,
                               max_err, gen)
                ms, peak = forward_peak(pnet, x)
                row.update(ms=ms, peak_bytes=peak, new_sites_held=len(new) if bi == 0 else 0)
                rows.append(row)
                print(f"  {label}: {ms:.3f} ms ({ms / ms0:.3f}x the default), peak "
                      f"{peak / 2**30:.3f} GiB, launches {tuple(launches[k] for k in names)}, "
                      f"{check}"
                      + (f", {len(new)} new kernel sites == plain" if bi == 0 and new else ""),
                      flush=True)
                del pnet, got
            # the default once more: the spread of host-bound forwards
            # across this block, beside its first reading
            ms1, peak1 = forward_peak(net, x)
            rows.append({"path": name, "batch": batch, "policy": "default_again", "ms": ms1,
                         "peak_bytes": peak1, "launches": base_launches})
            print(f"  default again: {ms1:.3f} ms ({ms1 / ms0:.3f}x the first reading)",
                  flush=True)
            del x, want, by_route
            torch.cuda.empty_cache()

    # the autotuner: a race, a hit, a truncated cache raced again
    tune = {}
    with tempfile.TemporaryDirectory() as tmp:
        cache = Path(tmp) / "autotune.json"
        for name, prep, model, net, size, batches, inputs, _ in paths:
            if name not in ("mobilenet_v2", "ssd_lite"):
                continue
            residual = {k: v for k, v in prep.params.items() if k not in model.layers}
            x = torch.from_numpy(np.resize(inputs, (BATCH,) + inputs.shape[1:])).to(DEVICE)
            pol, race = autotune_dw_policy(model, residual, x, cache_path=str(cache),
                                           rounds=AUTOTUNE_ROUNDS)
            if race["cached"] or len(race["rows"]) != 3:
                raise AssertionError(f"autotune {name}: {race}")
            for r in race["rows"]:
                print(f"autotune {name} b{BATCH} ({card}): {r['label']} {r['ms']:.4f} ms "
                      f"(rounds {r['ms_min']:.4f}-{r['ms_max']:.4f})", flush=True)
            _, hit = autotune_dw_policy(model, residual, x, cache_path=str(cache))
            if not hit["cached"] or hit["label"] != race["label"]:
                raise AssertionError(f"autotune {name}: no cache hit: {hit}")
            text = cache.read_text()
            cache.write_text(text[: len(text) // 2])
            _, again = autotune_dw_policy(model, residual, x, cache_path=str(cache),
                                          rounds=AUTOTUNE_ROUNDS)
            if again["cached"] or len(again["rows"]) != 3:
                raise AssertionError(f"autotune {name}: a truncated cache was not raced: {again}")
            json.loads(cache.read_text())
            print(f"autotune {name}: winner {race['label']} ({race['ms']:.4f} ms), cache hit "
                  f"{hit['label']}, truncated cache raced again without an exception: winner "
                  f"{again['label']}", flush=True)
            tune[name] = {"race": race, "hit": hit, "after_truncation": again, "policy": pol}
            del x

    # the roofline of the measured default forward
    graph = paths[0][2].graph
    ms = fwd_ms[("mobilenet_v2", BIG_BATCH)]
    roof = roofline_report(graph, BIG_BATCH, SIZE, peaks=device_peaks(),
                           measured_time_s=ms * 1e-3)
    roof = {k: v for k, v in roof.items() if k != "layers"}
    print(f"roofline MobileNetV2 b{BIG_BATCH} ({card}): per-layer bound {roof['t_sol_s'] * 1e3:.4f}"
          f" ms ({roof['bound']}-bound, {roof['memory_bound_time_fraction']:.3f} of it in "
          f"memory-bound layers), aggregate {roof['t_sol_aggregate_s'] * 1e3:.4f} ms; measured "
          f"{ms:.3f} ms: sol_fraction {roof['sol_fraction']:.4f}", flush=True)
    return {"launches": launches_by,
            "detail": {"card": card, "rows": rows, "autotune": tune, "roofline_mnv2_b128": roof}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from dfq_tpu_torch.engine import Int8FusedNet, Int8Net
    from dfq_tpu_torch.graph import execute
    from dfq_tpu_torch.graph.executor import params_to
    from dfq_tpu_torch.models import mobilenet_v2
    from dfq_tpu_torch.ops import _build
    from dfq_tpu_torch.ops import conv_epilogue as cep
    from dfq_tpu_torch.ops import cuda_int8 as ck
    from dfq_tpu_torch.serve import MicroBatcher
    from dfq_tpu_torch.utils.profiling import card_peaks

    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    detail = {}

    # 1. the card
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    peak_key, card_peak = card_peaks(kind)  # NVIDIA's data sheets (utils/profiling.py)
    mem_bw, int8_peak = card_peak["hbm_bytes"], card_peak["int8_ops"]
    print(f"card: {card} (peaks of {peak_key}: {mem_bw / 1e12} TB/s, "
          f"{int8_peak / 1e12} int8 TOP/s)", flush=True)

    # 2. build
    t0 = time.perf_counter()
    libs = _build.build()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)
    ptxas = {src: ptxas_report(Path(str(path) + ".log")) for src, path in libs.items()}
    for src, kernels in ptxas.items():
        for k in kernels:
            print(f"  {src}: {k['kernel']}: {k['registers']} registers, "
                  f"{k['smem']} B static smem, spills {k['spill_stores']} B st / "
                  f"{k['spill_loads']} B ld")
    detail["build_s"] = build_s
    detail["ptxas"] = ptxas
    spilled = [k["kernel"] for kernels in ptxas.values() for k in kernels
               if k["spill_stores"] or k["spill_loads"]]
    if spilled or not all(ptxas.values()):
        raise AssertionError(f"ptxas reports spills in {spilled} (or no report: {ptxas})")

    # the main path's network (built once; weights from the seed)
    prep, model, residual = flagship(mobilenet_v2)
    graph = model.graph
    net = Int8FusedNet(model, device=DEVICE)
    ref_net = Int8FusedNet(model, device=DEVICE, plain_kernels=True)
    wrappers = wrappers_of(ck)
    kinds = {k: sum(1 for _, kk, _ in net.kernel_sites if kk == k) for k in wrappers}
    if kinds != {"matmul_int8_requant": 11, "dw3x3_int8_requant": 5, "fused_block_int8": 12}:
        raise AssertionError(f"main path kernel sites {kinds}")

    gen = torch.Generator(device=DEVICE).manual_seed(0)

    # 3. every kernel against its plain version at every main-path site,
    # again at an odd batch, and at batch 128 where the inputs are largest
    # (the two 1.6 M-row K1 sites, the K2 sites) and for K3's largest and
    # widest blocks
    max_err = dict.fromkeys(wrappers, 0.0)
    max_err["conv_epilogue"] = 0.0
    k1 = [s for s in net.kernel_sites if s[1] == "matmul_int8_requant"]
    shapes1 = site_inputs(graph, 1, SIZE)

    def rows(site):  # M of a K1 site at batch 1
        return int(np.prod(shapes1[graph[site[0]].inputs[0]][:-1]))

    big = sorted(k1, key=rows)[-2:]
    big += [s for s in net.kernel_sites if s[1] == "dw3x3_int8_requant"]
    k3 = [s for s in net.kernel_sites if s[1] == "fused_block_int8"]
    big += [k3[0], k3[-1]]
    if [s[0] for s in big[-2:]] != ["features.3.conv.0", "features.17.conv.0"]:
        raise AssertionError(f"K3's first and last sites are {[s[0] for s in big[-2:]]}")
    checks = ([(s, BATCH) for s in net.kernel_sites] + [(s, ODD_BATCH) for s in net.kernel_sites]
              + [(s, BIG_BATCH) for s in big])
    hold_sites(graph, SIZE, checks, wrappers, max_err, gen)
    print(f"kernels == plain at all {len(net.kernel_sites)} sites at batch {BATCH} and at "
          f"batch {ODD_BATCH}, and at batch {BIG_BATCH} at {[s[0] for s in big]}: "
          f"max abs err {max_err}", flush=True)

    # 4. the main path
    rng = np.random.default_rng(0)
    images = np.clip(rng.normal(0, 1, (16, SIZE, SIZE, 3)), -2.117, 2.64).astype(np.float32)
    x8 = torch.from_numpy(images[:BATCH]).to(DEVICE)
    with torch.no_grad():
        ck.reset_counts()
        cep.reset_counts()
        logits = step_by_step(net, x8)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        variants = {k: dict(v) for k, v in ck.VARIANTS.items()}
        epilogue_launches("mobilenet_v2", net, BATCH, pin="mobilenet_v2")
        cep.reset_counts()
        ref = ref_net(x8)
        torch.cuda.synchronize()
        epilogue_launches("mobilenet_v2 plain-kernel net", ref_net, BATCH)
    if launches != {"matmul_int8_requant": 11, "dw3x3_int8_requant": 5,
                    "fused_block_int8": 12}:
        raise AssertionError(f"main path launches {launches}")
    if variants != {"matmul_int8_requant": {"mma": 11, "stream": 0, "dp4a": 0},
                    "dw3x3_int8_requant": {"strip": 1, "general": 0, "strip_s2": 4,
                                           "general_s2": 0},
                    "fused_block_int8": {"mma": 12, "general": 0}}:
        raise AssertionError(f"main path kernel variants {variants}")
    if ck.PLAIN_CALLS != dict.fromkeys(wrappers, 0):
        raise AssertionError(f"plain versions ran through the wrappers: {ck.PLAIN_CALLS}")
    lg, rf = logits.cpu().numpy(), ref.cpu().numpy()
    if lg.shape != (BATCH, 1000) or not np.isfinite(lg).all():
        raise AssertionError(f"logits {lg.shape}, finite={np.isfinite(lg).all()}")
    diff = float(np.abs(lg - rf).max())
    if diff > TOL or not (lg.argmax(-1) == rf.argmax(-1)).all():
        raise AssertionError(f"logits vs plain versions: max abs {diff}")
    print(f"main path: logits {lg.shape} finite, max abs vs plain {diff}, "
          f"launches {launches}, variants {variants}, conv epilogue "
          f"{EPILOGUE_SEEN['mobilenet_v2']} (plain-kernel net 0)", flush=True)
    detail["main_path"] = {"launches": launches, "variants": variants,
                           "max_abs_vs_plain": diff,
                           "argmax": lg.argmax(-1).tolist()}

    # 5. serving through MicroBatcher
    def forward_np(batch):
        with torch.no_grad():
            return net(torch.from_numpy(batch).to(DEVICE)).cpu().numpy()

    batcher = MicroBatcher(forward_np, images[0], buckets=(4, BATCH), max_wait_ms=20.0)
    try:
        futs = [batcher.submit(images[i]) for i in range(12)]
        answers = [f.result(timeout=120) for f in futs]
        futs = [batcher.submit(images[i]) for i in range(12, 16)]
        answers += [f.result(timeout=120) for f in futs]
        stats = batcher.stats()
    finally:
        batcher.stop()
    direct = forward_np(images)
    for i, a in enumerate(answers):
        if not np.array_equal(a, direct[i]):
            raise AssertionError(f"served answer {i} != row {i} of the batch forward")
    if len(stats.dispatch_sizes) < 2:
        raise AssertionError(f"served through one bucket only: {stats.dispatch_sizes}")
    print(f"serving: 16 requests, dispatches {stats.dispatch_sizes}, answers == batch "
          f"forward rows", flush=True)
    detail["serving"] = {"dispatch_sizes": stats.dispatch_sizes}

    # 6. times
    peaks = (mem_bw, int8_peak)
    rows = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                "bytes_ms": 0.0, "ops_ms": 0.0, "has_library": True}
            for k in wrappers}
    sites = []
    for batch in (BATCH, BIG_BATCH):
        for name, kernel, op in net.kernel_sites:
            x = site_input(graph, SIZE, kernel, name, batch, gen)
            t = time_site(kernel, op, x, wrappers, peaks)
            if t["library_ms"] is None and kernel == "matmul_int8_requant":
                print(f"no library yardstick at {name} b{batch} {tuple(x.shape)}: "
                      f"{INT_MM_RULE}", flush=True)
            t.update(batch=batch, node=name, split_bound_ms=(
                max(t["bytes_ms"], fused_block_split_bound_ms(op, tuple(x.shape), int8_peak))
                if kernel == "fused_block_int8" else None))
            sites.append(t)
            if batch == BIG_BATCH:
                r = rows[kernel]
                for key in ("ms", "device_ms", "plain_ms", "bytes_ms", "ops_ms", "bound_ms"):
                    r[key] += t[key]
                if t["library_ms"] is None:
                    r["has_library"] = False
                else:
                    r["library_ms"] += t["library_ms"]
    detail["sites"] = sites
    print_sites(sites)
    for batch in (BATCH, BIG_BATCH):
        k3_sites = [s for s in sites if s["kernel"] == "fused_block_int8" and s["batch"] == batch]
        print(f"K3 sum b{batch}: device ms {sum(s['device_ms'] for s in k3_sites):.4f}, bound "
              f"{sum(s['bound_ms'] for s in k3_sites):.4f}, split model "
              f"{sum(s['split_bound_ms'] for s in k3_sites):.4f}", flush=True)
    fwd = {}
    for batch in (BATCH, BIG_BATCH):
        xb = torch.from_numpy(np.resize(images, (batch, SIZE, SIZE, 3))).to(DEVICE)
        with torch.no_grad():
            rounds = [time_ms(lambda: net(xb), reps=5, rounds=1) for _ in range(7)]
        fwd[batch] = float(np.median(rounds))
        detail[f"forward_rounds_ms_b{batch}"] = rounds
        print(f"forward: batch {batch}: median {fwd[batch]:.3f} ms "
              f"({batch / fwd[batch] * 1e3:.0f} img/s), rounds min {min(rounds):.3f} "
              f"max {max(rounds):.3f} ms", flush=True)
    detail["forward_ms"] = fwd

    # 7. the golden artifact
    detail["golden"] = phase_golden(Path(__file__).resolve().parent)

    # 8. ResNet-18's path (its launch counts are read around its forward)
    r18 = phase_resnet(ck, images)
    detail["resnet18"] = r18["detail"]

    # 12. SSD-Lite, 13. DeepLab (their launch counts are read around their
    # forwards; phases 9 and 11 use their networks)
    ssd = phase_ssd(ck, wrappers, max_err, gen, out_dir)
    detail["ssd_lite"] = ssd["detail"]
    seg = phase_deeplab(ck, wrappers, max_err, gen, out_dir)
    detail["deeplab_mnv2"] = seg["detail"]

    # 13a. the glue convs' epilogue at every glue conv site of the four paths
    epi = phase_epilogue(
        [("mobilenet_v2", net, graph, SIZE, (BATCH, ODD_BATCH)),
         ("resnet18", r18["net"], r18["model"].graph, SIZE, (BATCH, ODD_BATCH)),
         ("ssd_lite", ssd["net"], ssd["model"].graph, SSD_SIZE, (BATCH, ODD_BATCH)),
         ("deeplab_mnv2", seg["net"], seg["model"].graph, SEG_SIZE, (SEG_BATCH, ODD_BATCH))],
        gen, mem_bw, max_err)
    detail["epilogue"] = epi

    # 9. every exact int8 product that is not a kernel, on the four paths
    base = Int8Net(model, residual, device=DEVICE)
    sizes = (BATCH, ODD_BATCH, BIG_BATCH)
    detail["exact_products"] = phase_exact_products(
        [("mobilenet_v2", model.graph, [("baseline", base), ("fused", net)], SIZE, sizes),
         ("resnet18", r18["model"].graph, [("baseline", r18["base"]), ("fused", r18["net"])],
          SIZE, sizes),
         ("ssd_lite", ssd["model"].graph, [("baseline", ssd["base"]), ("fused", ssd["net"])],
          SSD_SIZE, sizes),
         ("deeplab_mnv2", seg["model"].graph, [("baseline", seg["base"]), ("fused", seg["net"])],
          SEG_SIZE, (SEG_BATCH, ODD_BATCH, BATCH))],
        gen)

    # 10. the classification entry point
    detail["cli"] = phase_cli(out_dir)

    # 11. times: the three engines' forwards; K1 at ResNet-18's fc
    def simulator(p):
        sim_params = params_to(p.params, DEVICE)
        return lambda x: execute(p.graph, sim_params, x, act_ranges=p.act_ranges,
                                 device=DEVICE)

    engines = {"resnet18": (("fused", r18["net"]), ("baseline", r18["base"]),
                            ("simulator", simulator(r18["prep"]))),
               "mobilenet_v2": (("baseline", base), ("simulator", simulator(prep)))}
    times = {f"mobilenet_v2/fused/b{b}": fwd[b] for b in (BATCH, BIG_BATCH)}
    for path, batches in (("resnet18", (BATCH, BIG_BATCH)), ("mobilenet_v2", (BIG_BATCH,))):
        for batch in batches:
            xb = torch.from_numpy(np.resize(images, (batch, SIZE, SIZE, 3))).to(DEVICE)
            for eng, fn in engines[path]:
                times[f"{path}/{eng}/b{batch}"] = forward_ms(fn, xb)
    for key, ms in times.items():
        print(f"forward {key}: median {ms:.3f} ms ({int(key.rsplit('/b', 1)[1]) / ms * 1e3:.0f} "
              f"img/s)", flush=True)
    detail["engine_forward_ms"] = times
    fc_op = r18["net"].kernel_sites[0][2]
    wrap, plain = wrappers["matmul_int8_requant"]
    k1_fc = []
    for batch in (BATCH, BIG_BATCH):
        x = torch.randint(-128, 128, (batch, fc_op.w.shape[1]), generator=gen, device=DEVICE,
                          dtype=torch.int8)
        nbytes, nops = work("matmul_int8_requant", fc_op, tuple(x.shape),
                            wrap(x, fc_op).element_size())
        bytes_ms, ops_ms = nbytes / mem_bw * 1e3, nops / int8_peak * 1e3
        lib, _ = library_call("matmul_int8_requant", fc_op, x)
        k1_fc.append({"batch": batch, "shape": list(x.shape),
                      "ms": time_ms(lambda: wrap(x, fc_op)),
                      "device_ms": graph_ms(lambda: wrap(x, fc_op)),
                      "plain_ms": time_ms(lambda: plain(x, fc_op), reps=3, rounds=3),
                      "library_device_ms": None if lib is None else graph_ms(lib),
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
        print(f"K1 at ResNet-18's fc, b{batch} {tuple(x.shape)} -> {fc_op.n_out}: "
              f"{k1_fc[-1]}" + ("" if lib else f" (no library yardstick: {INT_MM_RULE})"),
              flush=True)
    detail["k1_resnet18_fc"] = k1_fc

    # the detection and segmentation paths: forwards with their peak memory,
    # device NMS, every kernel site
    seg_forward = {"fused": seg["net"], "baseline": seg["base"],
                   "simulator": simulator(seg["prep"])}
    ssd_forward = {"fused": ssd["net"], "baseline": ssd["base"],
                   "simulator": simulator(ssd["prep"])}
    memory = {}
    for path, fns, runs, inputs in (
            ("ssd_lite", ssd_forward, (("fused", 1), ("fused", BATCH), ("fused", BIG_BATCH),
                                       ("baseline", BATCH), ("simulator", BATCH)),
             ssd["inputs"]),
            ("deeplab_mnv2", seg_forward, (("fused", SEG_BATCH), ("fused", BATCH),
                                           ("baseline", SEG_BATCH), ("simulator", SEG_BATCH)),
             seg["images"])):
        for eng, batch in runs:
            xb = torch.from_numpy(inputs[:batch]).to(DEVICE)
            key = f"{path}/{eng}/b{batch}"
            times[key], memory[key] = forward_peak(fns[eng], xb)
            print(f"forward {key}: median {times[key]:.3f} ms ({batch / times[key] * 1e3:.1f} "
                  f"img/s), peak device memory {memory[key] / 2**30:.3f} GiB", flush=True)
            del xb
    detail["engine_forward_ms"] = times
    detail["peak_memory_bytes"] = memory
    from dfq_tpu_torch.detection.device_nms import decode_nms_batch

    priors = torch.from_numpy(ssd["priors"]).to(DEVICE)
    nms_ms = {}
    for batch in (1, BIG_BATCH):
        with torch.no_grad():
            conf, loc = ssd["net"](torch.from_numpy(ssd["inputs"][:batch]).to(DEVICE))
        nms_ms[batch] = time_ms(lambda: decode_nms_batch(conf, loc, priors), reps=5, rounds=5)
        print(f"decode_nms_batch b{batch} (prob 0.01, IoU 0.45, 200 candidates, top 10): "
              f"{nms_ms[batch]:.3f} ms", flush=True)
    detail["decode_nms_batch_ms"] = nms_ms
    new_sites = []
    seg_former = [s for s in seg["net"].kernel_sites if former_dp4a(ck, s[2])]
    for path, sites_, pgraph, size, batches in (
            ("ssd_lite", ssd["net"].kernel_sites, ssd["model"].graph, SSD_SIZE,
             (BATCH, BIG_BATCH)),
            ("deeplab_mnv2", seg["net"].kernel_sites, seg["model"].graph, SEG_SIZE,
             (SEG_BATCH,)),
            ("deeplab_mnv2", seg_former, seg["model"].graph, SEG_SIZE, (BATCH, BIG_BATCH))):
        for batch in batches:
            for name, kernel, op in sites_:
                x = site_input(pgraph, size, kernel, name, batch, gen)
                t = time_site(kernel, op, x, wrappers, peaks, reps=10, rounds=3)
                t.update(path=path, batch=batch, node=name)
                new_sites.append(t)
                del x
    print_sites(new_sites)
    for path, batch in (("ssd_lite", BATCH), ("ssd_lite", BIG_BATCH),
                        ("deeplab_mnv2", SEG_BATCH)):
        for k in wrappers:
            ks = [t for t in new_sites if t["path"] == path and t["batch"] == batch
                  and t["kernel"] == k]
            if ks:
                print(f"{path} b{batch} {k}: {len(ks)} sites, device ms "
                      f"{sum(t['device_ms'] for t in ks):.4f}, ms {sum(t['ms'] for t in ks):.4f}, "
                      f"bound {sum(t['bound_ms'] for t in ks):.4f}, plain "
                      f"{sum(t['plain_ms'] for t in ks):.3f}", flush=True)
    detail["sites_seg_det"] = new_sites
    former = []
    for path, net_, pgraph, size, batches in (
            ("ssd_lite", ssd["net"], ssd["model"].graph, SSD_SIZE, (BATCH, BIG_BATCH)),
            ("deeplab_mnv2", seg["net"], seg["model"].graph, SEG_SIZE, (SEG_BATCH, BATCH))):
        for batch in batches:
            for name, kernel, op in net_.kernel_sites:
                if kernel == "matmul_int8_requant" and former_dp4a(ck, op):
                    x = site_input(pgraph, size, kernel, name, batch, gen)
                    former.append(time_former_dp4a(ck, wrappers, peaks, path, batch, name, op, x))
                    del x
    detail["former_dp4a"] = former

    # 14. calibration (its launch counts are read around its forward)
    calib = phase_calibration(ck, wrappers, max_err, gen, images)
    detail["calibration"] = calib["detail"]

    # 15. the native deployment path, 16. the AOT cold start, 17. the zoo
    root = Path(__file__).resolve().parent
    detail["deployment"] = phase_deployment(root, out_dir)
    aot_run = phase_aot(root)
    detail["aot"] = {k: v for k, v in aot_run.items() if k != "launches"}
    zoo = phase_zoo(ck, wrappers, max_err, gen, peaks)
    detail["zoo"] = zoo["models"]
    detail["sites_zoo"] = zoo["sites"]
    detail["former_dp4a"] += zoo["former_dp4a"]
    by_path = {}
    for t in detail["former_dp4a"]:
        by_path.setdefault((t["path"], t["batch"]), []).append(t)
    for (path, batch), ts in by_path.items():
        lib = [t["library_device_ms"] for t in ts]
        print(f"former dp4a sites {path} b{batch} ({card}): {len(ts)} sites, device ms "
              f"{sum(t['device_ms'] for t in ts):.4f}, dp4a {sum(t['dp4a_device_ms'] for t in ts):.4f}, "
              f"bound {sum(t['bound_ms'] for t in ts):.4f}, padded _int_mm "
              + (f"{sum(lib):.4f}" if None not in lib else "none"), flush=True)

    # 18. parallel/ (its launch counts are read around each sharded run)
    par = phase_parallel(ck, wrappers, max_err, gen,
                         {"prep": prep, "model": model, "residual": residual, "net": net}, seg)
    detail["parallel"] = par["detail"]

    # 19. the fused engine's policies (launch counts are read around each forward)
    pol = phase_policies(ck, wrappers, max_err, gen, [
        ("mobilenet_v2", prep, model, net, SIZE, (BATCH, BIG_BATCH), images, POLICY_CPU_ROWS),
        ("resnet18", r18["prep"], r18["model"], r18["net"], SIZE, (BIG_BATCH,), images,
         POLICY_CPU_ROWS),
        ("ssd_lite", ssd["prep"], ssd["model"], ssd["net"], SSD_SIZE, (BATCH,), ssd["inputs"],
         slice(0, 2)),
        ("deeplab_mnv2", seg["prep"], seg["model"], seg["net"], SEG_SIZE, (SEG_BATCH,),
         seg["images"], slice(0, 1))], card)
    detail["policies"] = pol["detail"]

    # 20. the fused forward as a CUDA graph
    detail["graphs"] = phase_graphs(ck, [
        (path, p["model"], {k: v for k, v in p["prep"].params.items()
                            if k not in p["model"].layers}, size)
        for path, p, size in (("mobilenet_v2", {"model": model, "prep": prep}, SIZE),
                              ("resnet18", r18, SIZE), ("ssd_lite", ssd, SSD_SIZE),
                              ("deeplab_mnv2", seg, SEG_SIZE))], gen)
    ck.reset_counts()
    (out_dir / "chip_smoke.json").write_text(json.dumps(detail, indent=1))

    sources = {
        "matmul_int8_requant": ("dfq_tpu_torch/csrc/matmul_int8_requant.cu",
                                "dfq_tpu/ops/pallas_int8.py:137"),
        "dw3x3_int8_requant": ("dfq_tpu_torch/csrc/dw3x3_int8_requant.cu",
                               "dfq_tpu/ops/pallas_int8.py:359"),
        "fused_block_int8": ("dfq_tpu_torch/csrc/fused_block_int8.cu",
                             "dfq_tpu/ops/pallas_int8.py:607"),
    }
    line = []
    for k, r in rows.items():
        line.append({
            "name": k, "route": "cuda", "source": sources[k][0], "replaces": sources[k][1],
            "launches": launches[k], "max_abs_err": max_err[k], "batch": BIG_BATCH,
            "ms": r["ms"], "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
            "library_ms": r["library_ms"] if r["has_library"] else None,
            "launches_by_path": {"mobilenet_v2": launches[k],
                                 "resnet18": r18["launches"][k],
                                 "ssd_lite": ssd["launches"][k],
                                 "deeplab_mnv2": seg["launches"][k],
                                 "mobilenet_v2_calibrated": calib["launches"][k],
                                 "mobilenet_v2_aot": aot_run["launches"][k],
                                 **{m: r["launches"][k] for m, r in zoo["models"].items()},
                                 **{p: n[k] for p, n in par["launches"].items()},
                                 **{f"policies/{p}": n[k] for p, n in pol["launches"].items()}},
        })
    # the glue convs' epilogue: glue, no K-site; its times sum every glue
    # conv site of the four paths at their benchmark cells' batches
    ep_sum = {k: sum(r[k] for r in epi["by_path"].values())
              for k in ("ms", "device_ms", "plain_ms", "bound_ms")}
    line.append({
        "name": "conv_epilogue", "route": "cuda",
        "source": "dfq_tpu_torch/csrc/conv_epilogue_int8.cu", "replaces": None,
        "launches": EPILOGUE_SEEN["mobilenet_v2"], "max_abs_err": max_err["conv_epilogue"],
        "batch": {p: r["batch"] for p, r in epi["by_path"].items()}, **ep_sum,
        "bound_by": "bytes", "library_ms": None, "by_path": epi["by_path"],
        "host_us": {k: epi["host"][k] for k in ("wrapper_us", "bare_launch_us")},
        "launches_by_path": dict(EPILOGUE_SEEN),
    })
    for mod in ("jax", "dfq_tpu"):
        if mod in sys.modules:
            raise AssertionError(f"{mod} was imported")
    print(json.dumps({"kernels": line}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
