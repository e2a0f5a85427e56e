"""Find the highest request rate a served cell's system sustains: one set-up,
then the cell's open-loop traffic at each rate in turn.

    python3 -m portbench.knee --workload <served cell> --seed <n> --seconds 5 \\
        --rates 500 1000 2000 [--out knee.json]

For each rate it prints one JSON line: requests offered and completed,
latency p50/p95 over the window and over its first and last thirds by
due time (a backlog that grows over the window shows as a last third
far above the first), the generator's lateness, the batch fill and the
dispatch sizes. The cell's rate is set once, by hand, to about 4/5 of
the highest rate whose last third does not run away from its first.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

from portbench.run import ROOT, Setup, load_json


def summary(rate: float, rec: dict) -> dict:
    lat, due = rec["latencies_s"] * 1e3, rec["due_s"]
    third = rec["window_s"] / 3
    first, last = lat[due < third], lat[due >= 2 * third]
    b = rec["batcher"]

    def pct(x, q):
        return float(np.percentile(x, q)) if len(x) else None

    return {"rate": rate, "offered": rec["attempted"], "completed": rec["images"],
            "failed": rec["failed"], "p50_ms": pct(lat, 50), "p95_ms": pct(lat, 95),
            "p95_first_third_ms": pct(first, 95), "p95_last_third_ms": pct(last, 95),
            "lateness_p99_ms": pct(rec["lateness_s"] * 1e3, 99),
            "batch_fill": b["items"] / max(1, b["items"] + b["padded"]),
            "dispatch_sizes": rec["dispatch_sizes"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.knee: no CUDA card", file=sys.stderr)
        return 3
    bench = load_json(ROOT.parent / "BENCHMARK.json")
    s = Setup(bench, args.workload, args.seed, args.seconds, False, "cuda")
    rows = []
    for rate in args.rates:
        rows.append(summary(rate, s.traffic.run(rate=rate, seconds=args.seconds)))
        print(json.dumps(rows[-1]), flush=True)
    s.traffic.close()
    if args.out:
        Path(args.out).write_text(json.dumps({"card": torch.cuda.get_device_name(0),
                                              "workload": args.workload, "rows": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
