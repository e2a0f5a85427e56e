"""Readings of the control: the plain reference, put in the program's place
and computed one step below the precision the configuration states (int4
weights and activations for its int8), judged as a run judges the
program against the int8 reference. Not part of a benchmark run.

    python3 -m portbench.control --config mobilenet_v2_224 --seeds 1 2 3 [--rows 128]

Prints one JSON line per seed with each number beside its limit; a
control that passes no limit has failed, as it must.
"""

from __future__ import annotations

import argparse
import importlib
import json

import torch

from portbench import seeded
from portbench.reference import int8_model
from portbench.reference.dfq.prepare import QuantConfig, prepare
from portbench.run import ROOT, load_json


def reference_outputs(ref_graph, cfg: dict, params, images, device, bits: int, block: int = 32):
    quant = dict(cfg["quant"], bits_weight=bits, bits_activation=bits)
    prep = prepare(ref_graph, params, QuantConfig(**quant))
    ref = int8_model.Reference(int8_model.lower(prep, bits), device)
    outs = [ref(images[i:i + block]) for i in range(0, len(images), block)]
    return tuple(torch.cat([o[j] for o in outs]) for j in range(len(outs[0])))


def control_numbers(cfg: dict, seed: int, rows: int, device, bits: int = 4) -> dict:
    """The numbers a run compares, with the ``bits``-bit reference as the
    program's output, on ``rows`` images of the seed."""
    ref_mod = importlib.import_module(f"portbench.reference.{cfg['name']}")
    ref_graph = ref_mod.graph(cfg)
    gen = seeded.generator(seed, device)
    params = seeded.make_params(ref_graph, gen)
    images = seeded.make_images(rows, cfg, gen)
    want = reference_outputs(ref_graph, cfg, params, images, device, cfg["quant"]["bits_weight"])
    got = [o.float() for o in reference_outputs(ref_graph, cfg, params, images, device, bits)]
    if cfg["task"] == "detect":
        from portbench.reference import nms

        p = cfg["task_params"]
        priors = torch.as_tensor(ref_mod.priors(cfg), device=got[0].device)
        b, s, v = nms.decode_nms_batch(got[0], got[1], priors, **{
            k: p[k] for k in ("prob_threshold", "iou_threshold", "candidate_size", "top_k",
                              "center_variance", "size_variance")})
        kept = {"conf": got[0], "loc": got[1],
                "out": torch.cat([b, s[..., None], v[..., None].to(b.dtype)], -1)}
    else:
        kept = {"out": got[0]}
    judge = importlib.import_module(f"portbench.reference.{cfg['task']}").judge
    return judge(kept, want, ref_mod, cfg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--rows", type=int, default=128)
    ap.add_argument("--bits", type=int, default=4)
    args = ap.parse_args(argv)
    cfg = load_json(ROOT / "configs" / f"{args.config}.json")
    device = "cuda" if torch.cuda.is_available() else "cpu"
    for seed in args.seeds:
        nums = control_numbers(cfg, seed, args.rows, device, args.bits)
        print(json.dumps({"config": args.config, "seed": seed, "bits": args.bits,
                          "device": device, "rows": args.rows,
                          "numbers": {k: {"value": v, "limit": cfg["limits"][k]}
                                      for k, v in nums.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
