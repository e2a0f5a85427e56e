#!/usr/bin/env python3
"""Drive the PyTorch port (``dfq_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. print the card's name and power limit (``nvidia-smi``);
2. build the CUDA kernels from ``dfq_tpu_torch/csrc`` (build time, and
   nvcc's register / spill report);
3. hold every kernel against its plain PyTorch version on the card, at
   every call site of the main path (MobileNetV2 at 224x224, batch 8),
   on random int8 inputs from a seeded ``torch.Generator``: int8 and f32
   outputs must be bit-equal;
4. the main path: full-width MobileNetV2 with random weights
   (``init_params(seed=0, bn_stats="random")``), the flagship DFQ config
   (``prepare``), ``lower_int8`` and ``Int8FusedNet`` on the card, batch 8
   at 224x224: the launch counts must read 11 / 1 / 12 per forward, and
   the logits must equal (atol 1e-4, same argmax) the same network run
   with the plain versions on the card;
5. serving, as a correctness check: 16 single-image requests through
   ``MicroBatcher`` over two batch buckets, each answer equal to its row
   of a direct batch forward (no latency is measured: 16 requests of
   made-up traffic say nothing of it);
6. times (CUDA events, median of several runs after warm-up): each kernel
   at its main-path shapes at batch 8 and 128 beside its bound, its plain
   version and a library yardstick (``torch._int_mm`` takes only
   M > 16 and K, N multiples of 8: a K1 site outside that has none, and
   the script says so); the forward at batch 8 and 128.

It prints the ``kernels`` JSON line, then the card line, then as the last
line ``{"ok": true, "device": {...}}``. Per-site details go to
``chiprun_out/chip_smoke.json``. Without CUDA it exits 2 and prints no
result.
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
SIZE = 224
TOL = 1e-4  # logits, as the CPU slice test (tests/test_int8_fused.py:102)

# (memory bytes/s, dense int8 ops/s) by card; NVIDIA data sheets
_PEAKS = {
    "H200": (4.8e12, 1979e12),
    "H100 PCIe": (2.0e12, 1513e12),
    "H100": (3.35e12, 1979e12),  # SXM (HBM3)
}


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


def work(kernel: str, op, shape, out_bytes: int):
    """(bytes, int8 ops) the function must move and do: each input read
    once, each output written once."""
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from dfq_tpu_torch.engine import Int8FusedNet, lower_int8
    from dfq_tpu_torch.models import init_params, mobilenet_v2
    from dfq_tpu_torch.ops import _build
    from dfq_tpu_torch.ops import cuda_int8 as ck
    from dfq_tpu_torch.pipeline import QuantConfig, prepare
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
    for src, path in libs.items():
        log = Path(str(path) + ".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {src}: {line.strip()}")
    detail["build_s"] = build_s

    # the main path's network (built once; weights from the seed)
    graph = mobilenet_v2()
    params = init_params(graph, seed=0, bn_stats="random")
    cfg = QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                      correction=True, bits_bias=16)
    model = lower_int8(prepare(graph, params, cfg))
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

    # 3. every kernel against its plain version at every main-path site
    max_err = dict.fromkeys(wrappers, 0.0)
    for name, kernel, op in net.kernel_sites:
        wrap, plain = wrappers[kernel]
        x = site_input(kernel, name, BATCH)
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
    print(f"kernels == plain at all {len(net.kernel_sites)} sites (batch {BATCH}): "
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
        ref = ref_net(x8)
        torch.cuda.synchronize()
    if launches != {"matmul_int8_requant": 11, "dw3x3_int8_requant": 1,
                    "fused_block_int8": 12}:
        raise AssertionError(f"main path launches {launches}")
    if ck.PLAIN_CALLS != dict.fromkeys(wrappers, 0):
        raise AssertionError(f"plain versions ran through the wrappers: {ck.PLAIN_CALLS}")
    lg, rf = logits.cpu().numpy(), ref.cpu().numpy()
    if lg.shape != (BATCH, 1000) or not np.isfinite(lg).all():
        raise AssertionError(f"logits {lg.shape}, finite={np.isfinite(lg).all()}")
    diff = float(np.abs(lg - rf).max())
    if diff > TOL or not (lg.argmax(-1) == rf.argmax(-1)).all():
        raise AssertionError(f"logits vs plain versions: max abs {diff}")
    print(f"main path: logits {lg.shape} finite, max abs vs plain {diff}, "
          f"launches {launches}", flush=True)
    detail["main_path"] = {"launches": launches, "max_abs_vs_plain": diff,
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
    rows = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
                "bytes_ms": 0.0, "ops_ms": 0.0, "has_library": True} for k in wrappers}
    sites = []
    for batch in (BATCH, BIG_BATCH):
        for name, kernel, op in net.kernel_sites:
            wrap, plain = wrappers[kernel]
            x = site_input(kernel, name, batch)
            out = wrap(x, op)
            nbytes, nops = work(kernel, op, tuple(x.shape), out.element_size())
            t_k = time_ms(lambda: wrap(x, op))
            t_p = time_ms(lambda: plain(x, op), reps=3, rounds=3)
            lib = library_call(kernel, op, x)
            t_l = None if lib is None else time_ms(lib)
            if lib is None and kernel == "matmul_int8_requant":
                print(f"no library yardstick at {name} b{batch} {tuple(x.shape)}: "
                      f"{INT_MM_RULE}", flush=True)
            bytes_ms, ops_ms = nbytes / mem_bw * 1e3, nops / int8_peak * 1e3
            sites.append({"batch": batch, "node": name, "kernel": kernel,
                          "shape": list(x.shape), "ms": t_k, "plain_ms": t_p,
                          "library_ms": t_l, "bytes": nbytes, "ops": nops,
                          "bound_ms": max(bytes_ms, ops_ms),
                          "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"})
            if batch == BIG_BATCH:
                r = rows[kernel]
                r["ms"] += t_k
                r["plain_ms"] += t_p
                r["bytes_ms"] += bytes_ms
                r["ops_ms"] += ops_ms
                r["bound_ms"] += max(bytes_ms, ops_ms)
                if t_l is None:
                    r["has_library"] = False
                else:
                    r["library_ms"] += t_l
    detail["sites"] = sites
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
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes" if r["bytes_ms"] >= r["ops_ms"] else "operations",
            "library_ms": r["library_ms"] if r["has_library"] else None,
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
