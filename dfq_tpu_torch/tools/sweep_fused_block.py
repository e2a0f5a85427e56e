"""Time K3 at its MobileNetV2 main-path shape classes under forced plans.

    python3 dfq_tpu_torch/tools/sweep_fused_block.py --out chiprun_out/sweep_k3.json

For each chunk width ``--ec`` (0 = the plan's own), each of the 7 shape
classes and each batch, the device time (CUDA-graph replay, as
``chip_smoke.py:graph_ms``) of ``fused_block_int8_packed`` under the plan
``fused_block_plan`` picks and under every forced (slab rows, column
split) of ``--rows`` x ``--split`` for which ``fused_block_candidate``
has a plan. It is how the
plan's heuristics (slab height by batch, column split, chunk width) were
chosen; every forced plan's output is checked against the picked plan's.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path)
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 128])
    ap.add_argument("--ec", type=int, nargs="+", default=[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[2, 4, 7, 8, 14])
    ap.add_argument("--split", type=int, nargs="+", default=[1, 2, 4])
    args = ap.parse_args()

    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(ROOT))
    from dfq_tpu_torch.engine import Int8FusedNet, lower_int8
    from dfq_tpu_torch.models import init_params, mobilenet_v2
    from dfq_tpu_torch.ops import cuda_int8 as ck
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    if not torch.cuda.is_available():
        raise RuntimeError("sweep_fused_block: CUDA is not available")
    graph = mobilenet_v2()
    params = init_params(graph, seed=0, bn_stats="random")
    cfg = QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                      correction=True, bits_bias=16)
    model = lower_int8(prepare(graph, params, cfg))
    plan_fn, ec_fn = ck.fused_block_plan, ck.fused_block_ec
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for ec in args.ec:
        ck.fused_block_ec = ec_fn if ec == 0 else (lambda C, E, C2, ec=ec: ec)
        ck.fused_block_fits.cache_clear()
        net = Int8FusedNet(model, device="cuda")
        seen = set()
        for name, kernel, op in net.kernel_sites:
            if kernel != "fused_block_int8":
                continue
            for batch in args.batches:
                shape = cs.site_inputs(graph, batch, cs.SIZE)[graph[name].inputs[0]]
                key = (shape, op.E, op.C2)
                if key in seen:
                    continue
                seen.add(key)
                x = torch.randint(-128, 128, shape, generator=gen, device="cuda",
                                  dtype=torch.int8)
                N, H, W, C = shape

                def run(plan):
                    # the wrapper asks fused_block_plan; give it this plan
                    ck.fused_block_plan = lambda *a, **k: plan
                    op.launch_args.clear()
                    out = ck.fused_block_int8_packed(x, op)
                    ms = cs.graph_ms(lambda: ck.fused_block_int8_packed(x, op))
                    return out, ms

                picked = plan_fn(N, H, W, C, op.E, op.C2)
                want, ms = run(picked)
                row = {"ec": picked.ec, "node": name, "shape": list(shape), "E": op.E,
                       "C2": op.C2, "picked": [picked.bh, picked.grid[1]],
                       "picked_ms": ms,
                       "forced": {}}
                for rows in sorted({min(r, H) for r in args.rows}):
                    for split in args.split:
                        # None where the kernel cannot run it (a block
                        # without columns, tiles or shared memory)
                        plan = ck.fused_block_candidate(N, H, W, C, op.E, op.C2, rows, split)
                        if plan is None:
                            continue
                        out, ms = run(plan)
                        if not torch.equal(out, want):
                            raise AssertionError(f"{name} rows {rows} split {split} differs")
                        row["forced"][f"{rows}x{split}"] = ms
                ck.fused_block_plan = plan_fn
                op.launch_args.clear()
                best = min(row["forced"], key=row["forced"].get)
                print(f"ec {picked.ec} b{batch} {name} {tuple(shape)}->{op.E}->{op.C2}: picked "
                      f"{picked.bh}x{picked.grid[1]} {row['picked_ms']:.4f} ms; best {best} "
                      f"{row['forced'][best]:.4f}; "
                      + " ".join(f"{k}={v:.4f}" for k, v in row["forced"].items()), flush=True)
                results.append(row)
    ck.fused_block_ec = ec_fn
    ck.fused_block_fits.cache_clear()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": cs.nvidia_smi_line(), "rows": results},
                                       indent=1))
    print("card: " + cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
