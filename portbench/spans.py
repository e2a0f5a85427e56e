"""Device time and device idle by the program's own spans.

While a profiler runs, the fused engine opens one range per step,
``int8_fused/<kind>:<node>``, and the phase ranges ``int8_fused/product``,
``int8_fused/requant`` and ``int8_fused/epilogue`` inside the steps; the
device NMS opens ``device_nms/decode_nms_batch``. :func:`attribute` ties
each device op of a profiled stretch to the innermost of those ranges that
was open on the host when it was launched, through the launch's
correlation (the op's linked correlation id names the host op that
launched it; without one, the runtime call with the op's own correlation
id), and sums:

- the glue's device time (every device op that is neither one of the three
  hand-written kernels nor launched inside NMS: the numerator of
  ``glue_ms_per_image.*``) by phase, by step kind and by node, and the
  part launched outside any step range;
- the device-idle time between busy intervals, by the innermost program
  range open on the host over it, and its overlap with the NMS ranges.

:func:`nms_host_syncs` is the reader of ``nms_host_syncs.det``.

    python3 -m portbench.spans --workload <cell> --seed <n> [--steps 10] [--seconds 3]

runs a cell's program on the card: steps back to back for ``--seconds``
with no profiler; ``--steps`` steps each after a device synchronisation
(the forward's host time, NMS's host syncs), in turns without and with a
profiler running, twice; one forward with
``torch.cuda.set_sync_debug_mode("error")``; and a profiled stretch of
``--steps`` steps back to back. It prints the tables on standard error
and one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import sys
import time
from typing import Dict, List, Optional, Sequence

import torch

from portbench.trace import NMS_SPAN, kernel_of

PROGRAM = ("int8_fused/", "device_nms/")
NMS = "device_nms/decode_nms_batch"
PHASES = {"int8_fused/product": "product", "int8_fused/requant": "requant",
          "int8_fused/epilogue": "epilogue"}


@dataclasses.dataclass(frozen=True)
class Event:
    """One profiler event: times in us on the profiler's clock; ``id`` its
    correlation id, ``linked`` the correlation id of the host op that
    launched it (device ops and runtime calls; 0 for host ops)."""

    name: str
    on_device: bool
    start: float
    end: float
    thread: int = 0
    id: int = 0
    linked: int = 0
    annotation: bool = False


def events_of(prof) -> List[Event]:
    """A finished ``torch.profiler.profile``'s events. A device-side
    annotation (a ``record_function`` range) is marked as ``trace.py``
    marks it."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.events():
        dev = e.device_type == DeviceType.CUDA
        out.append(Event(e.name, dev, e.time_range.start, e.time_range.end, e.thread, e.id,
                         getattr(e, "linked_correlation_id", 0) or 0,
                         dev and (getattr(e, "is_user_annotation", False) or e.name == NMS_SPAN)))
    return out


def _is_program(name: str) -> bool:
    return name.startswith(PROGRAM)


def _is_runtime(name: str) -> bool:
    return name.startswith(("cuda", "cu"))


class _Ranges:
    """The program's ranges on one host thread, nested: the innermost one
    open at a time, and each one's enclosing range."""

    def __init__(self, spans: Sequence[Event]):
        self.spans = sorted(spans, key=lambda s: (s.start, -s.end))
        self.starts = [s.start for s in self.spans]
        self.index = {id(s): i for i, s in enumerate(self.spans)}
        self.parent: List[Optional[int]] = []
        stack: List[int] = []
        for i, s in enumerate(self.spans):
            while stack and self.spans[stack[-1]].end < s.start:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)

    def at(self, t: float) -> Optional[int]:
        """The innermost range open at ``t``: of the ranges that start by
        ``t``, the last; then its enclosing ranges, until one is open."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i is not None and i >= 0 and self.spans[i].end < t:
            i = self.parent[i]
        return i if i is not None and i >= 0 else None

    def step_of(self, i: Optional[int]) -> Optional[Event]:
        while i is not None and ":" not in self.spans[i].name:
            i = self.parent[i]
        return self.spans[i] if i is not None else None

    def nms_of(self, i: Optional[int]) -> bool:
        while i is not None:
            if self.spans[i].name == NMS:
                return True
            i = self.parent[i]
        return False


def _step_label(name: str):
    """``int8_fused/<kind>:<node>`` -> ``(kind, node)``."""
    kind, _, node = name[len("int8_fused/"):].partition(":")
    return kind, node


def _add(d: Dict[str, float], key: str, s: float) -> None:
    d[key] = d.get(key, 0.0) + s


def _busy(intervals):
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap(a: float, b: float, ranges: Sequence[Event]) -> float:
    return sum(max(0.0, min(b, r.end) - max(a, r.start)) for r in ranges)


def attribute(events: Sequence[Event]) -> Dict:
    """Sums of a profiled stretch by the program's ranges (module
    docstring), in seconds; dictionaries keyed by phase (``product``,
    ``requant``, ``epilogue``; ``step``: a step's own ops outside its
    phases; ``outside``: no step range), by step kind and by node."""
    host = [e for e in events if not e.on_device]
    device = [e for e in events if e.on_device and not e.annotation]
    by_thread: Dict[int, List[Event]] = {}
    for e in host:
        if _is_program(e.name):
            by_thread.setdefault(e.thread, []).append(e)
    ranges = {t: _Ranges(s) for t, s in by_thread.items()}
    launchers = {e.id: e for e in host if e.linked == 0}
    runtime = {e.id: e for e in host if e.linked != 0 or _is_runtime(e.name)}
    via = {"linked": 0, "runtime": 0, "none": 0}

    phase: Dict[str, float] = {}
    kinds: Dict[str, float] = {}
    nodes: Dict[str, float] = {}
    glue = nms_device = 0.0
    for d in device:
        s = (d.end - d.start) / 1e6
        h, how = (launchers.get(d.linked), "linked") if d.linked else (None, "")
        if h is None:
            h, how = runtime.get(d.id), "runtime"
        via[how if h is not None else "none"] += 1
        r = ranges.get(h.thread) if h is not None else None
        i = None
        if r is not None:
            i = r.index.get(id(h))
            if i is None:
                i = r.at((h.start + h.end) / 2)
        if r is not None and r.nms_of(i):
            nms_device += s
            continue
        if kernel_of(d.name) is not None:
            continue
        glue += s
        step = r.step_of(i) if r is not None else None
        if step is None:
            _add(phase, "outside", s)
            continue
        _add(phase, PHASES.get(r.spans[i].name, "step"), s)
        kind, node = _step_label(step.name)
        _add(kinds, kind, s)
        _add(nodes, node, s)

    merged = _busy((d.start, d.end) for d in device)
    gaps = [(merged[k][1], merged[k + 1][0]) for k in range(len(merged) - 1)]
    main = max(ranges, key=lambda t: len(ranges[t].spans), default=None)
    idle: Dict[str, float] = {}
    nms_idle = 0.0
    nms_ranges = [s for r in ranges.values() for s in r.spans if s.name == NMS]
    if main is not None:
        r = ranges[main]
        cuts = sorted({t for s in r.spans for t in (s.start, s.end)})
        for a, b in gaps:
            nms_idle += _overlap(a, b, nms_ranges) / 1e6
            pts = [a] + cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)] + [b]
            for lo, hi in zip(pts, pts[1:]):
                i = r.at((lo + hi) / 2)
                _add(idle, _idle_label(r, i), (hi - lo) / 1e6)
    else:
        for a, b in gaps:
            _add(idle, "outside", (b - a) / 1e6)
    return {"glue_s": glue, "glue_unattributed_s": phase.get("outside", 0.0),
            "glue_by_phase_s": phase,
            "glue_by_kind_s": kinds, "glue_by_node_s": nodes,
            "program_nms_device_s": nms_device, "program_nms_calls": len(nms_ranges),
            "idle_s": sum(b - a for a, b in gaps) / 1e6, "idle_by_span_s": idle,
            "nms_idle_s": nms_idle, "launches_found": via}


def _idle_label(r: _Ranges, i: Optional[int]) -> str:
    if i is None:
        return "outside"
    name = r.spans[i].name
    step = r.step_of(i)
    if step is None:
        return name
    kind, _ = _step_label(step.name)
    return f"{PHASES[name]} in {kind}" if name in PHASES else f"{kind} step"


def nms_host_syncs(t: Dict) -> Optional[float]:
    """Host syncs per ``decode_nms_batch`` call over the run: the
    program's counters (``device_nms.COUNTS``); nothing where the program
    has none. A value below ``top_k`` means the loop stopped early, which
    this reports on standard error."""
    from dfq_tpu_torch.detection import device_nms

    counts = getattr(device_nms, "COUNTS", None)
    if not counts or not counts["calls"]:
        return None
    print(f"nms counters: {json.dumps(counts)}", file=sys.stderr, flush=True)
    return counts["host_syncs"] / counts["calls"]


def _synced(task, ring, net, steps: int, sync, acc: Dict) -> None:
    """``steps`` steps, each after a device synchronisation, adding to
    ``acc`` the forward's calls and host seconds (its counter) and NMS's
    calls, host syncs and early stops."""
    from dfq_tpu_torch.detection import device_nms

    before = (net.host.calls, net.host.seconds, dict(device_nms.COUNTS))
    for i in range(steps):
        sync()
        task.step(ring[i % len(ring)])
    sync()
    _add(acc, "calls", net.host.calls - before[0])
    _add(acc, "host_s", net.host.seconds - before[1])
    for k, v in device_nms.COUNTS.items():
        _add(acc, f"nms_{k}", v - before[2][k])


def _per_call(acc: Dict) -> Dict:
    out = {"host_dispatch_ms": 1e3 * acc["host_s"] / acc["calls"], "forwards": acc["calls"]}
    if acc["nms_calls"]:
        out.update(nms_calls=acc["nms_calls"], nms_early_stops=acc["nms_early_stops"],
                   nms_host_syncs=acc["nms_host_syncs"] / acc["nms_calls"])
    return out


def measure(setup, steps: int, seconds: float) -> Dict:
    """What the module docstring lists, for a ``run.Setup`` whose traffic
    holds a device ring (``closed_batch``)."""
    from portbench.trace import Stretch, _profiler

    cuda = setup.cuda
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    task, ring, net = setup.prog.task, setup.traffic.ring, setup.prog.net
    batch = ring.shape[1]
    out: Dict = {"steps": steps, "batch": batch}
    with torch.no_grad():
        sync()
        t0, n = time.perf_counter(), 0
        while n < steps or time.perf_counter() - t0 < seconds:
            task.step(ring[n % len(ring)])
            n += 1
        sync()
        out["window_ms_per_step"] = 1e3 * (time.perf_counter() - t0) / n
        # synchronised steps, in turns without and with a profiler running
        plain: Dict = {}
        profiled: Dict = {}
        for _ in range(2):
            _synced(task, ring, net, steps, sync, plain)
            p = _profiler()
            p.start()
            _synced(task, ring, net, steps, sync, profiled)
            p.stop()
        out["synced"], out["synced_profiled"] = _per_call(plain), _per_call(profiled)
        if cuda:
            sync()
            torch.cuda.set_sync_debug_mode("error")
            try:
                net(ring[0])
                out["forward_host_syncs"] = "none"
            except RuntimeError as e:
                out["forward_host_syncs"] = str(e).splitlines()[0][:200]
            finally:
                torch.cuda.set_sync_debug_mode(0)
        sync()
        prof = _profiler()
        prof.start()
        t0 = time.perf_counter()
        for i in range(steps):
            task.step(ring[i % len(ring)])
        sync()
        window = time.perf_counter() - t0
        prof.stop()
    out["traced_ms_per_step"] = 1e3 * window / steps
    st = Stretch()
    st.prof, st.window_s = prof, window
    summ = st.summary()
    out["attributed"] = attribute(events_of(prof))
    glue = sum(op[1] for op in summ["device_ops"]) - sum(
        k["s"] for k in summ["kernels"].values()) - summ["nms_device_s"]
    out["trace_py"] = {"glue_s": glue, "busy_s": summ["busy_s"], "nms_calls": summ["nms_calls"],
                       "nms_device_s": summ["nms_device_s"]}
    a = out["attributed"]
    images = steps * batch
    out["readings"] = {
        "glue_product_ms_per_image": 1e3 * a["glue_by_phase_s"].get("product", 0.0) / images,
        "glue_epilogue_ms_per_image": 1e3 * (a["glue_by_phase_s"].get("requant", 0.0)
                                             + a["glue_by_phase_s"].get("epilogue", 0.0)) / images,
        "glue_ms_per_image": 1e3 * a["glue_s"] / images,
        "host_dispatch_ms": out["synced"]["host_dispatch_ms"],
        "nms_host_syncs": out["synced"].get("nms_host_syncs"),
        "nms_idle_ms_per_batch": 1e3 * a["nms_idle_s"] / steps if a["program_nms_calls"] else None,
    }
    return out


def tables(out: Dict) -> str:
    """The glue by step kind and by node (top 15), and the idle by
    innermost program range, as text."""
    a, steps = out["attributed"], out["steps"]
    lines = [f"glue device ms per step: {1e3 * a['glue_s'] / steps:.4f} "
             f"(unattributed to a step: {100 * a['glue_unattributed_s'] / max(a['glue_s'], 1e-12):.3f}%;"
             f" trace.py's glue {1e3 * out['trace_py']['glue_s'] / steps:.4f})"]
    for title, d in (("by phase", a["glue_by_phase_s"]), ("by step kind", a["glue_by_kind_s"]),
                     ("by node (top 15)", a["glue_by_node_s"])):
        lines.append(f"glue device ms per step, {title}:")
        for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:15]:
            lines.append(f"  {k:<40} {1e3 * v / steps:9.4f}")
    lines.append(f"idle ms per step by innermost program range: {1e3 * a['idle_s'] / steps:.4f} "
                 f"(NMS {1e3 * a['nms_idle_s'] / steps:.4f})")
    for k, v in sorted(a["idle_by_span_s"].items(), key=lambda kv: -kv[1])[:15]:
        lines.append(f"  {k:<40} {1e3 * v / steps:9.4f}")
    return "\n".join(lines)


def main(argv=None) -> int:
    from portbench import run

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    bench = run.load_json(run.ROOT.parent / "BENCHMARK.json")
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA card", file=sys.stderr)
        return 3
    setup = run.Setup(bench, args.workload, args.seed, args.seconds, True, "cuda")
    out = measure(setup, args.steps, args.seconds)
    out.update(workload=args.workload, seed=args.seed, card=run.power_limit(),
               torch=torch.__version__)
    print(tables(out), file=sys.stderr, flush=True)
    out["attributed"]["glue_by_node_s"] = dict(sorted(
        out["attributed"]["glue_by_node_s"].items(), key=lambda kv: -kv[1])[:15])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
