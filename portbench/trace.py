"""A traced stretch of a run's window, reduced to the sums the per-layer
metrics read.

``torch.profiler`` (CPU and CUDA activities) runs over a short steady
stretch between two device synchronisations; only sums leave this
module: device time and calls by operation name and by hand-written
kernel, the union of device-busy intervals, and the longest idle gaps,
each named by the innermost host operation that was running across its
middle. Nothing is written to disk.
"""

from __future__ import annotations

import re
import time
from typing import Dict, List, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

# the hand-written kernels' device function names (dfq_tpu_torch/csrc/)
KERNELS = {
    "matmul_int8_requant": re.compile(r"\bmm_(mma|stream|dp4a)_kernel\b"),
    "dw3x3_int8_requant": re.compile(r"\bdw3x3_\w+_kernel\b"),
    "fused_block_int8": re.compile(r"\bfused_block(_mma)?_kernel\b"),
}
NMS_SPAN = "portbench.nms"


def kernel_of(name: str) -> Optional[str]:
    for kernel, pat in KERNELS.items():
        if pat.search(name):
            return kernel
    return None


def _profiler():
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:  # host operations of the serving threads too, where the version can
        cfg = torch.profiler._ExperimentalConfig(profile_all_threads=True)
        return profile(activities=acts, experimental_config=cfg)
    except (TypeError, AttributeError):
        return profile(activities=acts)


class Stretch:
    def __init__(self):
        self.prof = None
        self.window_s = 0.0

    def warm(self) -> None:
        """Start and stop the profiler once (its first start initialises
        the device tracer), so that the stretch does not pay it."""
        p = _profiler()
        p.start()
        torch.cuda.synchronize()
        p.stop()

    def start(self) -> None:
        torch.cuda.synchronize()
        self.prof = _profiler()
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()

    def summary(self) -> Dict:
        events = self.prof.events()
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        # a record_function range shows on the device too, as an annotation
        # spanning the kernels launched inside it: not an operation
        dev, nms_ranges = [], []
        for e in events:
            if e.device_type != DeviceType.CUDA:
                continue
            if getattr(e, "is_user_annotation", False) or e.name == NMS_SPAN:
                if e.name == NMS_SPAN:
                    nms_ranges.append((e.time_range.start, e.time_range.end))
            else:
                dev.append(e)
        by_name: Dict[str, List[float]] = {}
        kernels = {k: {"s": 0.0, "calls": 0} for k in KERNELS}
        nms_s = 0.0
        spans = []
        for e in dev:
            a, b = e.time_range.start, e.time_range.end
            spans.append((a, b))
            s = (b - a) / 1e6
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += s
            acc[1] += 1
            k = kernel_of(e.name)
            if k is not None:
                kernels[k]["s"] += s
                kernels[k]["calls"] += 1
            elif any(lo <= a <= hi for lo, hi in nms_ranges):
                nms_s += s
        spans.sort()
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        busy_s = sum(b - a for a, b in merged) / 1e6
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                       for i in range(len(merged) - 1)), reverse=True)[:10]
        named_gaps = [[self._host_at(cpu, (a + b) / 2), g / 1e6] for g, a, b in gaps]
        ops = sorted(([n, v[0], v[1]] for n, v in by_name.items()), key=lambda r: -r[1])
        return {"busy_s": busy_s, "window_s": self.window_s, "device_ops": ops,
                "kernels": kernels, "nms_device_s": nms_s, "nms_calls": len(nms_ranges),
                "gaps": named_gaps}

    @staticmethod
    def _host_at(cpu, t: float) -> str:
        best = None
        for e in cpu:
            r = e.time_range
            if r.start <= t <= r.end and (best is None or r.start > best.time_range.start):
                best = e
        return best.name if best is not None else "host Python, no traced operation"

