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
   at 224x224: the launch counts must read 11 / 1 / 12 per forward, every
   K1 and K3 launch must have taken the tensor-core variant and the K2
   launch the strip variant, and the logits must equal (atol 1e-4, same argmax)
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
9. every conv that has no kernel, at every call site of both models, at
   batch 8 and 3 and, at each model's largest sites, batch 128, through
   the packed product each engine holds (``products``), against
   ``F.conv2d`` in float64 on the card (exact: every sum is below 2^53),
   and the baseline engine's linear layers against a float64 product: the
   int32 accumulators must be bit-equal;
10. the classification entry point in-process (``run_cls --resnet
   --quantize --relu --equalize``), once with ``--engine fused`` and once
   with ``--engine int8``, each saving its artifact: the artifact reloaded
   through the same engine reproduces the entry point's logits bit for
   bit;
11. times (CUDA events, medians): ResNet-18's forward at batch 8 and 128
   through the fused engine, the baseline engine and the simulator; K1 at
   ResNet-18's ``fc`` beside its bound and ``torch._int_mm``; MobileNetV2's
   three engines at batch 128.

It prints the ``kernels`` JSON line (with each kernel's launches on each
model's path), then the card line, then as the last line ``{"ok": true,
"device": {...}}``. Per-site details go to ``chiprun_out/chip_smoke.json``.
Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import json
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

# (memory bytes/s, dense int8 ops/s) by card; NVIDIA data sheets
_PEAKS = {
    "H200": (4.8e12, 1979e12),
    "H100 PCIe": (2.0e12, 1513e12),
    "H100": (3.35e12, 1979e12),  # SXM (HBM3)
}


# dp4a instructions per second of one H100 SXM, lanes counted: 63 per clock
# and SM (dfq_tpu_torch/tools/pipe_rates.py measured 62-64 at 1,980 MHz on
# an NVIDIA H100 80GB HBM3 at 700 W) x 132 SMs; each does 4 int8 MACs, of
# which a 3x3 depthwise row sum uses 3. A recorded rate, below the pipe's
# nominal 64: it enters fused_block_split_bound_ms only, never bound_ms
DP4A_PER_S = 63 * 132 * 1.98e9


def card_peaks(name: str):
    for key, peaks in _PEAKS.items():
        if key in name:
            return key, peaks
    raise RuntimeError(f"no peak table for card {name!r}")


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
        N = op.w.shape[0]
        return M * K + N * K + 12 * N + M * N * out_bytes, 2 * M * N * K
    if kernel == "dw3x3_int8_requant":
        n = int(np.prod(shape))
        C = shape[-1]
        return n + 17 * C + n * out_bytes, 2 * 9 * n
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


def library_call(kernel: str, op, x):
    """One PyTorch call computing the kernel's core, never used by the
    port: the int8 product for K1, the f32 depthwise MAC for K2; None
    where there is none (K3) or the shape is outside ``INT_MM_RULE``."""
    import torch
    import torch.nn.functional as F

    if kernel == "matmul_int8_requant":
        M, K = x.shape
        N = op.w.shape[0]
        if M <= 16 or K % 8 or N % 8:
            return None
        w_kn = op.w.t()  # column-major [K, N], cuBLASLt's layout
        return lambda: torch._int_mm(x, w_kn)
    if kernel == "dw3x3_int8_requant":
        C = x.shape[-1]
        xf = x.permute(0, 3, 1, 2).float().contiguous(memory_format=torch.channels_last)
        wf = op.taps.t().reshape(C, 1, 3, 3).float().contiguous()
        return lambda: F.conv2d(xf, wf, padding=1, groups=C)
    return None


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


def flagship(graph_fn):
    """The flagship DFQ config on a model with random weights from the seed:
    ``(prepared, lowered, residual f32 params)``."""
    from dfq_tpu_torch.engine import lower_int8
    from dfq_tpu_torch.models import init_params
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    graph = graph_fn()
    cfg = QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                      correction=True, bits_bias=16)
    prep = prepare(graph, init_params(graph, seed=0, bn_stats="random"), cfg)
    model = lower_int8(prep)
    return prep, model, {k: v for k, v in prep.params.items() if k not in model.layers}


def forward_ms(fn, x, rounds: int = 7) -> float:
    """Median over ``rounds`` of 5 synchronised forwards, as phase 6."""
    import torch

    with torch.no_grad():
        return float(np.median([time_ms(lambda: fn(x), reps=5, rounds=1)
                                for _ in range(rounds)]))


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

    prep, model, residual = flagship(resnet18)
    net = Int8FusedNet(model, device=DEVICE)
    ref_net = Int8FusedNet(model, device=DEVICE, plain_kernels=True)
    base = Int8Net(model, residual, device=DEVICE)
    if [(n, k) for n, k, _ in net.kernel_sites] != [("fc", "matmul_int8_requant")]:
        raise AssertionError(f"ResNet-18 kernel sites {net.kernel_sites}")
    x8 = torch.from_numpy(images[:BATCH]).to(DEVICE)
    with torch.no_grad():
        ck.reset_counts()
        logits = net(x8)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        ref = ref_net(x8)
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
    print(f"ResNet-18: logits {lg.shape} finite, max abs vs plain {diff}, launches {launches}; "
          f"baseline engine: fused top-1 in its top 5 {in_top5}, argmax agreement {agree}; "
          f"simulator card vs CPU {sim}", flush=True)
    return {"prep": prep, "model": model, "residual": residual, "net": net, "base": base,
            "launches": launches,
            "detail": {"launches": launches, "max_abs_vs_plain": diff, "in_top5": in_top5,
                       "argmax_agree_baseline": agree, "simulator": sim,
                       "argmax": lg.argmax(-1).tolist()}}


def conv_work(graph, name: str, batch: int) -> int:
    """MACs of one conv at ``batch`` (224x224)."""
    node = graph[name]
    out = site_inputs(graph, batch, SIZE)[name]
    a = node.attrs
    return int(np.prod(out)) * a["in_ch"] // a["groups"] * a["kernel"][0] * a["kernel"][1]


def phase_exact_products(paths, gen) -> dict:
    """9. Every packed int8 product that is not a kernel (every lowered conv
    and linear of the baseline engine, every non-kernel conv of the fused
    engine) against float64 on the card, at batch 8 and 3 and, at the
    largest site of each route of each model, 128: bit-equal int32."""
    import torch
    import torch.nn.functional as F

    from dfq_tpu_torch.engine.int8 import int8_conv, int8_linear

    n_checked = 0
    routes = {}
    for model_name, graph, engines in paths:
        names = sorted({n for _, e in engines for n in e.products},
                       key=lambda n: [x.name for x in graph].index(n))
        route = {n: next(e.products[n].route for _, e in engines if n in e.products)
                 for n in names}
        convs = [n for n in names if graph[n].op == "conv"]
        big = {max((n for n in convs if route[n] == r), key=lambda n: conv_work(graph, n, 1))
               for r in set(route[n] for n in convs)}
        checks = [(n, b) for b in (BATCH, ODD_BATCH) for n in names] + [
            (n, BIG_BATCH) for n in sorted(big)]
        for name, batch in checks:
            node = graph[name]
            shape = site_inputs(graph, batch, SIZE)[node.inputs[0]]
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
            del x, want
        print(f"{model_name}: {len(names)} exact int8 products (routes "
              f"{ {r: sum(1 for n in names if route[n] == r) for r in set(route.values())} }) "
              f"bit-equal to float64 at batch {BATCH} and {ODD_BATCH}, and at batch "
              f"{BIG_BATCH} at {sorted(big)}", flush=True)
    return {"checks": n_checked, "routes": routes}


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
    from dfq_tpu_torch.ops import cuda_int8 as ck
    from dfq_tpu_torch.serve import MicroBatcher

    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    detail = {}

    # 1. the card
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    peak_key, (mem_bw, int8_peak) = card_peaks(kind)
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
    wrappers = {
        "matmul_int8_requant": (ck.matmul_int8_requant_packed, ck.matmul_int8_requant_plain),
        "dw3x3_int8_requant": (ck.dw3x3_int8_requant_packed, ck.dw3x3_int8_requant_plain),
        "fused_block_int8": (ck.fused_block_int8_packed, ck.fused_block_int8_plain),
    }
    kinds = {k: sum(1 for _, kk, _ in net.kernel_sites if kk == k) for k in wrappers}
    if kinds != {"matmul_int8_requant": 11, "dw3x3_int8_requant": 1, "fused_block_int8": 12}:
        raise AssertionError(f"main path kernel sites {kinds}")

    gen = torch.Generator(device=DEVICE).manual_seed(0)

    def site_input(kernel, name, batch):
        node = graph[name]
        shape = site_inputs(graph, batch, SIZE)[node.inputs[0]]
        x = torch.randint(-128, 128, shape, generator=gen, device=DEVICE, dtype=torch.int8)
        if kernel == "matmul_int8_requant":
            x = x.reshape(-1, shape[-1])
        return x

    # 3. every kernel against its plain version at every main-path site,
    # again at an odd batch, and at batch 128 where the inputs are largest
    # (the two 1.6 M-row K1 sites, the K2 site) and for K3's largest and
    # widest blocks
    max_err = dict.fromkeys(wrappers, 0.0)
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
    for (name, kernel, op), batch in checks:
        wrap, plain = wrappers[kernel]
        x = site_input(kernel, name, batch)
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
        del got, want
    print(f"kernels == plain at all {len(net.kernel_sites)} sites at batch {BATCH} and at "
          f"batch {ODD_BATCH}, and at batch {BIG_BATCH} at {[s[0] for s in big]}: "
          f"max abs err {max_err}", flush=True)

    # 4. the main path
    rng = np.random.default_rng(0)
    images = np.clip(rng.normal(0, 1, (16, SIZE, SIZE, 3)), -2.117, 2.64).astype(np.float32)
    x8 = torch.from_numpy(images[:BATCH]).to(DEVICE)
    with torch.no_grad():
        ck.reset_counts()
        logits = net(x8)
        torch.cuda.synchronize()
        launches = dict(ck.LAUNCHES)
        variants = {k: dict(v) for k, v in ck.VARIANTS.items()}
        ref = ref_net(x8)
        torch.cuda.synchronize()
    if launches != {"matmul_int8_requant": 11, "dw3x3_int8_requant": 1,
                    "fused_block_int8": 12}:
        raise AssertionError(f"main path launches {launches}")
    if variants != {"matmul_int8_requant": {"mma": 11, "dp4a": 0},
                    "dw3x3_int8_requant": {"strip": 1, "general": 0},
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
          f"launches {launches}, variants {variants}", flush=True)
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
    rows = {k: {"ms": 0.0, "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                "bytes_ms": 0.0, "ops_ms": 0.0, "has_library": True}
            for k in wrappers}
    sites = []
    for batch in (BATCH, BIG_BATCH):
        for name, kernel, op in net.kernel_sites:
            wrap, plain = wrappers[kernel]
            x = site_input(kernel, name, batch)
            out = wrap(x, op)
            nbytes, nops = work(kernel, op, tuple(x.shape), out.element_size())
            t_k = time_ms(lambda: wrap(x, op))
            t_d = graph_ms(lambda: wrap(x, op))
            t_p = time_ms(lambda: plain(x, op), reps=3, rounds=3)
            lib = library_call(kernel, op, x)
            t_l = None if lib is None else time_ms(lib)
            t_ld = None if lib is None else graph_ms(lib)
            if lib is None and kernel == "matmul_int8_requant":
                print(f"no library yardstick at {name} b{batch} {tuple(x.shape)}: "
                      f"{INT_MM_RULE}", flush=True)
            bytes_ms, ops_ms = nbytes / mem_bw * 1e3, nops / int8_peak * 1e3
            split_ms = (max(bytes_ms, fused_block_split_bound_ms(op, tuple(x.shape), int8_peak))
                        if kernel == "fused_block_int8" else None)
            sites.append({"batch": batch, "node": name, "kernel": kernel,
                          "shape": list(x.shape), "ms": t_k, "device_ms": t_d,
                          "plain_ms": t_p, "library_ms": t_l, "library_device_ms": t_ld,
                          "bytes": nbytes, "ops": nops,
                          "bound_ms": max(bytes_ms, ops_ms),
                          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                          "split_bound_ms": split_ms})
            if batch == BIG_BATCH:
                r = rows[kernel]
                r["ms"] += t_k
                r["device_ms"] += t_d
                r["plain_ms"] += t_p
                r["bytes_ms"] += bytes_ms
                r["ops_ms"] += ops_ms
                r["bound_ms"] += max(bytes_ms, ops_ms)
                if t_l is None:
                    r["has_library"] = False
                else:
                    r["library_ms"] += t_l
    detail["sites"] = sites
    print("per site: batch node shape | ms (host calls) | ms (device, graph replay) "
          "| bound ms (by) | library ms (host calls / device) | device ms / bound "
          "[| K3: split model ms (this design's units at their rates), device ms / it]")
    for s in sites:
        lib = ("none" if s["library_ms"] is None
               else f"{s['library_ms']:.4f} / {s['library_device_ms']:.4f}")
        print(f"  b{s['batch']} {s['node']} {tuple(s['shape'])} | {s['ms']:.4f} | "
              f"{s['device_ms']:.4f} | {s['bound_ms']:.4f} ({s['bound_by']}) | {lib} | "
              f"{s['device_ms'] / s['bound_ms']:.1f}x"
              + ("" if s["split_bound_ms"] is None else
                 f" | {s['split_bound_ms']:.4f}, {s['device_ms'] / s['split_bound_ms']:.1f}x"),
              flush=True)
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

    # 9. every exact int8 product that is not a kernel, on both paths
    base = Int8Net(model, residual, device=DEVICE)
    detail["exact_products"] = phase_exact_products(
        [("mobilenet_v2", model.graph, [("baseline", base), ("fused", net)]),
         ("resnet18", r18["model"].graph, [("baseline", r18["base"]), ("fused", r18["net"])])],
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
        lib = library_call("matmul_int8_requant", fc_op, x)
        k1_fc.append({"batch": batch, "shape": list(x.shape),
                      "ms": time_ms(lambda: wrap(x, fc_op)),
                      "device_ms": graph_ms(lambda: wrap(x, fc_op)),
                      "plain_ms": time_ms(lambda: plain(x, fc_op), reps=3, rounds=3),
                      "library_device_ms": None if lib is None else graph_ms(lib),
                      "bound_ms": max(bytes_ms, ops_ms),
                      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
        print(f"K1 at ResNet-18's fc, b{batch} {tuple(x.shape)} -> {fc_op.w.shape[0]}: "
              f"{k1_fc[-1]}" + ("" if lib else f" (no library yardstick: {INT_MM_RULE})"),
              flush=True)
    detail["k1_resnet18_fc"] = k1_fc
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
                                 "resnet18": r18["launches"][k]},
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
