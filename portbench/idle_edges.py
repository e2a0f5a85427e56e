"""Where a traced stretch's device idle lies, for a closed-loop cell's
program: before the first device operation (the host issuing the first
step: ``lead_ms``), between device operations (``gaps_ms``) and after the
last (``trail_ms``), beside the stretch's ``window_ms`` and ``busy_ms``.
Three stretches of 10 steps each, after 30 steps of warm-up.

    python3 -m portbench.idle_edges <cell> [seed]
"""

import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import record_function

from portbench import run
from portbench.trace import _profiler


def main(cell: str, seed: int) -> None:
    bench = run.load_json(run.ROOT.parent / "BENCHMARK.json")
    s = run.Setup(bench, cell, seed, 10, True, "cuda")
    task, ring = s.prog.task, s.traffic.ring
    with torch.no_grad():
        for i in range(30):
            task.step(ring[i % len(ring)])
        for rep in range(3):
            torch.cuda.synchronize()
            prof = _profiler()
            prof.start()
            t0 = time.perf_counter()
            with record_function("edge/start"):
                pass
            for i in range(10):
                task.step(ring[i % len(ring)])
            torch.cuda.synchronize()
            with record_function("edge/end"):
                pass
            window = time.perf_counter() - t0
            prof.stop()
            ev = prof.events()
            dev = sorted((e.time_range.start, e.time_range.end) for e in ev
                         if e.device_type == DeviceType.CUDA
                         and not getattr(e, "is_user_annotation", False))
            marks = {e.name: e.time_range.start for e in ev if e.name.startswith("edge/")}
            busy, gaps, end = 0.0, 0.0, dev[0][0]
            for a, b in dev:
                if a > end:
                    gaps += a - end
                busy += max(0.0, b - max(a, end))
                end = max(end, b)
            print(f"{cell} rep {rep}: window_ms {window * 1e3:.3f} busy_ms {busy / 1e3:.3f} "
                  f"lead_ms {(dev[0][0] - marks['edge/start']) / 1e3:.3f} "
                  f"gaps_ms {gaps / 1e3:.3f} trail_ms {(marks['edge/end'] - end) / 1e3:.3f}",
                  flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 2500000201)
