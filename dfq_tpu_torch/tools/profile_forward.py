"""Where the fused forward's time goes on the card.

    python -m dfq_tpu_torch.tools.profile_forward [--model resnet18] [--batch 8 128]

Builds a path at full width (MobileNetV2 224x224 by default; ResNet-18
224x224, SSD-Lite 300x300 or DeepLab-v3+ MobileNetV2 513x513 with
``--model resnet18|ssd_lite|deeplab``; random weights from seed 0, the
flagship DFQ config, ``Int8FusedNet`` on CUDA), warms it up, then
traces 5 forwards per batch size with ``torch.profiler``. Prints
one JSON line per batch: wall time per forward (host clock, synchronised),
device busy time per forward (the sum of the traced kernels' durations),
the device's idle share, and the kernels by total device time. Writes the
Chrome trace of the last batch to ``chiprun_out/forward_trace_<model>.json``.
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
from dfq_tpu_torch.models import (
    deeplab_mobilenet_v2,
    init_params,
    mobilenet_v2,
    mobilenet_v2_ssd_lite,
    resnet18,
)
from dfq_tpu_torch.pipeline import QuantConfig, prepare


# --model: (builder, input size, extra QuantConfig flags)
MODELS = {
    "mobilenet_v2": (mobilenet_v2, 224, {}),
    "resnet18": (resnet18, 224, {}),
    "ssd_lite": (mobilenet_v2_ssd_lite, 300, {"delete_single": True, "is_detection": True}),
    "deeplab": (deeplab_mobilenet_v2, 513, {}),
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, nargs="+", default=[8, 128])
    ap.add_argument("--model", choices=sorted(MODELS), default="mobilenet_v2")
    args = ap.parse_args(argv)
    steps = 5
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: CUDA is not available")

    build, size, extra = MODELS[args.model]
    graph = build()
    cfg = QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                      correction=True, bits_bias=16, **extra)
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
            "model": args.model, "batch": batch, "device": torch.cuda.get_device_name(0),
            "wall_ms": wall,
            "device_busy_ms": busy if busy > 0 else "not measured",
            "idle_share": 1 - busy / wall if busy > 0 else "not measured",
            "top": [{"ms": ms, "calls": n, "name": name[:90]} for ms, n, name in kernels[:12]],
        }), flush=True)
        prof.export_chrome_trace(str(out_dir / f"forward_trace_{args.model}.json"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
