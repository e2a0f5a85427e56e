"""Time K1, K2 and K3 at every main-path site, for one source tree.

    python3 dfq_tpu_torch/tools/time_sites.py [--model resnet18] --root TREE --out FILE.json
    python3 dfq_tpu_torch/tools/time_sites.py --summarize A.json B.json ...

Run as a script (not with ``-m``), so that ``--root`` decides which
``dfq_tpu_torch`` is imported: the tree this file lies in by default, or
another checkout of the repository (say the parent commit, unpacked with
``git archive`` into a directory that ``.gitignore`` lists). Two versions
of a kernel are compared by running this once per tree inside one command
on one card, in turns (old, new, new, old): two commands may land on two
cards. The timings are ``chip_smoke.py``'s, at batch 8 and 128, on the
same seeded inputs for every tree: ``ms`` between CUDA events around 20
back-to-back calls from the host (median of 5 rounds after a warm-up),
which reads the host's per-call cost wherever that is the larger, and
``device_ms`` from the same calls replayed as one CUDA graph.

The network is full-width MobileNetV2 (the default) or ResNet-18
(``--model resnet18``: its one kernel site is K1 at the ``fc``). The
whole forward is timed too, per batch, as ``chip_smoke.py`` times it:
between CUDA events around 5 forwards, 15 rounds (median, least, most).

``--summarize`` prints one row per site from several such files, in the
order given (each file's ``ms / device_ms``), with the sums per batch and
kernel and the forwards.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE_ROOT = Path(__file__).resolve().parents[2]
KERNELS = ("matmul_int8_requant", "dw3x3_int8_requant", "fused_block_int8")


def measure(root: Path, batches, model: str = "mobilenet_v2") -> dict:
    import importlib.util

    import torch

    # chip_smoke's helpers always from this tree, the package from `root`
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE_ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    sys.path.insert(0, str(root))
    from dfq_tpu_torch.engine import Int8FusedNet, lower_int8
    from dfq_tpu_torch import models
    from dfq_tpu_torch.ops import cuda_int8 as ck
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    if not torch.cuda.is_available():
        raise RuntimeError("time_sites: CUDA is not available")
    graph = getattr(models, model)()
    params = models.init_params(graph, seed=0, bn_stats="random")
    cfg = QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                      correction=True, bits_bias=16)
    net = Int8FusedNet(lower_int8(prepare(graph, params, cfg)), device="cuda")
    wrappers = {"matmul_int8_requant": ck.matmul_int8_requant_packed,
                "dw3x3_int8_requant": ck.dw3x3_int8_requant_packed,
                "fused_block_int8": ck.fused_block_int8_packed}
    gen = torch.Generator(device="cuda").manual_seed(0)
    sites = []
    for batch in batches:
        for name, kernel, op in net.kernel_sites:
            shape = cs.site_inputs(graph, batch, cs.SIZE)[graph[name].inputs[0]]
            x = torch.randint(-128, 128, shape, generator=gen, device="cuda",
                              dtype=torch.int8)
            if kernel == "matmul_int8_requant":
                x = x.reshape(-1, shape[-1])
            wrap = wrappers[kernel]
            sites.append({"batch": batch, "node": name, "kernel": kernel,
                          "shape": list(x.shape), "ms": cs.time_ms(lambda: wrap(x, op)),
                          "device_ms": cs.graph_ms(lambda: wrap(x, op))})
    forward = {}
    for batch in batches:
        xb = torch.randn((batch, cs.SIZE, cs.SIZE, 3), generator=gen, device="cuda")
        with torch.no_grad():
            forward[str(batch)] = [cs.time_ms(lambda: net(xb), reps=5, rounds=1)
                                   for _ in range(15)]
    return {"root": str(root), "model": model, "card": cs.nvidia_smi_line(),
            "kind": torch.cuda.get_device_name(0), "sites": sites, "forward_ms": forward}


def summarize(files) -> None:
    runs = [json.loads(Path(f).read_text()) for f in files]
    print("card: " + " | ".join(sorted({r["card"] for r in runs})))
    print("columns (ms / device_ms): " + " | ".join(f"{Path(f).stem}" for f in files))
    for i, s in enumerate(runs[0]["sites"]):
        row = " | ".join(f"{r['sites'][i]['ms']:.4f} / {r['sites'][i]['device_ms']:.4f}"
                         for r in runs)
        print(f"b{s['batch']} {s['kernel']} {s['node']} {tuple(s['shape'])}: {row}")
    for batch in sorted({s["batch"] for s in runs[0]["sites"]}):
        for kernel in KERNELS:
            sums = [[sum(s[key] for s in r["sites"]
                         if s["batch"] == batch and s["kernel"] == kernel)
                     for key in ("ms", "device_ms")] for r in runs]
            print(f"sum b{batch} {kernel}: "
                  + " | ".join(f"{a:.4f} / {b:.4f}" for a, b in sums))
    for batch in sorted({s["batch"] for s in runs[0]["sites"]}):
        rounds = [sorted(r.get("forward_ms", {}).get(str(batch), [])) for r in runs]
        print(f"forward b{batch} ms, median (least - most): " + " | ".join(
            f"{r[len(r) // 2]:.3f} ({r[0]:.3f} - {r[-1]:.3f})" if r else "none"
            for r in rounds))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=HERE_ROOT)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--batches", type=int, nargs="+", default=[8, 128])
    ap.add_argument("--summarize", nargs="+", metavar="JSON")
    ap.add_argument("--model", choices=["mobilenet_v2", "resnet18"], default="mobilenet_v2")
    args = ap.parse_args()
    if args.summarize:
        summarize(args.summarize)
        return 0
    result = measure(args.root.resolve(), args.batches, args.model)
    text = json.dumps(result, indent=1)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(json.dumps({"root": result["root"], "card": result["card"],
                      "sum_ms": {f"b{b}/{k}": sum(s["ms"] for s in result["sites"]
                                                   if s["batch"] == b and s["kernel"] == k)
                                 for b in args.batches for k in KERNELS}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
