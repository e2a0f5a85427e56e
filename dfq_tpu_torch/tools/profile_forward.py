"""Where the fused forward's time goes on the card.

    python -m dfq_tpu_torch.tools.profile_forward [--batch 8 128]

Builds the main path (full-width MobileNetV2, random weights from seed 0,
the flagship DFQ config, ``Int8FusedNet`` on CUDA), warms it up, then
traces 5 forwards per batch size with ``torch.profiler``. Prints
one JSON line per batch: wall time per forward (host clock, synchronised),
device busy time per forward (the sum of the traced kernels' durations),
the device's idle share, and the kernels by total device time. Writes the
Chrome trace of the last batch to ``chiprun_out/forward_trace.json``.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from dfq_tpu_torch.engine import Int8FusedNet, lower_int8
from dfq_tpu_torch.models import init_params, mobilenet_v2
from dfq_tpu_torch.pipeline import QuantConfig, prepare


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 128])
    args = ap.parse_args(argv)
    steps, size = 5, 224
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: CUDA is not available")

    graph = mobilenet_v2()
    cfg = QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                      correction=True, bits_bias=16)
    model = lower_int8(prepare(graph, init_params(graph, seed=0, bn_stats="random"), cfg))
    net = Int8FusedNet(model, device="cuda")
    rng = np.random.default_rng(0)
    out_dir = Path(__file__).resolve().parents[2] / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for batch in args.batch:
        x = torch.from_numpy(np.clip(rng.normal(0, 1, (batch, size, size, 3)),
                                     -2.117, 2.64).astype(np.float32)).cuda()
        with torch.no_grad():
            for _ in range(3):
                net(x)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    net(x)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / steps * 1e3
        kernels = []
        busy_us = 0.0
        for e in prof.key_averages():
            dev_us = e.self_device_time_total
            # device-side events only (kernels, copies); the CPU ops that
            # launched them carry the same time again
            if e.device_type == DeviceType.CUDA and dev_us > 0:
                busy_us += dev_us
                kernels.append((dev_us / steps / 1e3, e.count // steps, e.key))
        kernels.sort(reverse=True)
        busy = busy_us / steps / 1e3
        print(json.dumps({
            "batch": batch, "device": torch.cuda.get_device_name(0),
            "wall_ms": wall,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "idle_share": 1 - busy / wall if busy > 0 else "not measured",
            "top": [{"ms": ms, "calls": n, "name": name[:90]} for ms, n, name in kernels[:12]],
        }), flush=True)
        prof.export_chrome_trace(str(out_dir / "forward_trace.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
