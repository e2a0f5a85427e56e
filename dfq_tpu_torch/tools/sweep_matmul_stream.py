"""Time K1's streamed variant at the model zoo's long-K shapes under forced plans.

    python3 dfq_tpu_torch/tools/sweep_matmul_stream.py --out chiprun_out/sweep_k1s.json

For each shape (``M K N``: by default DRN-D-54's and ResNet-101's K = 2048
convs at DeepLab 513x513 b4 and AlexNet's classifier at b8), the device
time (CUDA-graph replay, as ``chip_smoke.py:graph_ms``) of
``matmul_int8_requant_packed`` under the plan ``matmul_plan`` picks and
under every forced (row strips, slice bytes, ring stages, columns, K
parts) of the options for which ``matmul_stream_candidate`` has a plan.
Every forced plan's output is checked against the plain version.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SHAPES = ["16900,2048,512", "4356,2048,512", "4356,2048,256", "8,9216,4096", "8,4096,4096",
          "8,4096,1000"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--shapes", nargs="+", default=SHAPES, help="M,K,N")
    ap.add_argument("--wr", type=int, nargs="+", default=[1, 4, 8])
    ap.add_argument("--ks", type=int, nargs="+", default=[128, 256])
    ap.add_argument("--stages", type=int, nargs="+", default=[2, 3, 4])
    ap.add_argument("--bn", type=int, nargs="+", default=[32, 64])
    ap.add_argument("--parts", type=int, nargs="+", default=[1, 4])
    args = ap.parse_args()

    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(ROOT))
    from dfq_tpu_torch.ops import cuda_int8 as ck

    if not torch.cuda.is_available():
        raise RuntimeError("sweep_matmul_stream: CUDA is not available")
    card = cs.nvidia_smi_line()
    plan_fn = ck.matmul_plan
    rng = np.random.default_rng(0)
    results = []
    for shape in args.shapes:
        M, K, N = (int(v) for v in shape.split(","))
        w = rng.integers(-128, 128, (N, K)).astype(np.int8)
        op = ck.pack_matmul(w, rng.uniform(1e-6, 2e-5, N).astype(np.float32),
                            rng.normal(0, 1, N).astype(np.float32), w.astype(np.int32).sum(1),
                            zp_in=-5, s_out=0.0371, zp_out=-20, device="cuda")
        x = torch.randint(-128, 128, (M, K), dtype=torch.int8, device="cuda")
        want = ck.matmul_int8_requant_plain(x, op)
        picked = plan_fn(M, K, N)
        rows = []
        forced = itertools.product(args.wr, args.ks, args.stages, args.bn, args.parts)
        for choice in itertools.chain([None], forced):
            plan = picked if choice is None else ck.matmul_stream_candidate(
                M, K, N, False, *choice)
            if plan is None or (choice is not None and plan == picked):
                continue
            ck.matmul_plan = lambda *a, plan=plan, **k: plan
            op.launch_args.clear()
            try:
                got = ck.matmul_int8_requant_packed(x, op)
                torch.cuda.synchronize()
                if not torch.equal(got, want):
                    raise AssertionError(f"{shape} {plan}: differs from the plain version")
                ms = cs.graph_ms(lambda: ck.matmul_int8_requant_packed(x, op), 10, 3)
            finally:
                ck.matmul_plan = plan_fn
                op.launch_args.clear()
            rows.append({"shape": [M, K, N], "picked": choice is None, "device_ms": ms,
                         "wr": plan.wr, "ks": plan.ks, "stages": plan.stages, "bn": plan.bn,
                         "grid": list(plan.grid), "smem": plan.smem})
        rows.sort(key=lambda r: r["device_ms"])
        pick = next(r for r in rows if r["picked"])
        print(f"{shape} ({card}): picked {pick['device_ms']:.4f} ms (wr {pick['wr']} ks "
              f"{pick['ks']} stages {pick['stages']} bn {pick['bn']} grid {pick['grid']}); "
              f"{len(rows)} plans, best {rows[0]['device_ms']:.4f}, worst "
              f"{rows[-1]['device_ms']:.4f}", flush=True)
        for r in rows[:5]:
            print(f"  {r['device_ms']:.4f} wr {r['wr']} ks {r['ks']} stages {r['stages']} "
                  f"bn {r['bn']} grid {r['grid']} smem {r['smem']}", flush=True)
        results += rows
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "results": results}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
