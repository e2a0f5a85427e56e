"""Deployment conversion on the port (counterpart of
``dfq_tpu/cli/convert.py``, the reference's ``convert_ncnn.py`` analog).

Runs the DFQ pipeline in the ncnn-compatible regime (symmetric signed
weights, 32-bit bias: the Int8' rows, ``convert_ncnn.py:29,109,115``),
lowers to int8 and exports both artifact formats:

- the int8 artifact directory (``--out``; the format of
  :mod:`dfq_tpu_torch.io.artifact`, which the JAX package loads too), and
- the native runtime pair ``<out>_native.dfqparam/.dfqbin`` read by
  ``native/`` (:class:`dfq_tpu_torch.engine.native.NativeModel`).

``--validate`` runs the exported native model on the host against the
port's baseline int8 engine (``Int8Net``) on ``--device`` at 2 seeded
224x224 images: every top-1 must agree, and the largest difference is
printed.

Example::

    python -m dfq_tpu_torch.cli.convert --relu --equalize --out out/mnv2 \\
        --checkpoint mobilenetv2.pth --validate
"""

from __future__ import annotations

import argparse

import numpy as np


def get_argument(argv=None):
    p = argparse.ArgumentParser(description="export a DFQ int8 model for deployment")
    for flag in ("--resnet", "--equalize", "--correction", "--absorption", "--relu",
                 "--clip_weight", "--validate"):
        p.add_argument(flag, action="store_true")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of --validate's int8 engine (cuda, or cpu)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the conversion; returns the lowered ``model``, its residual f32
    ``params`` and, with ``--validate``, the two engines' ``native`` and
    ``engine`` outputs and their ``top1_agreement`` and ``max_abs``."""
    args = get_argument(argv)
    import torch

    from dfq_tpu_torch.cli.common import load_checkpoint
    from dfq_tpu_torch.device import resolve_device
    from dfq_tpu_torch.engine import Int8Net, lower_int8
    from dfq_tpu_torch.io import save_artifact
    from dfq_tpu_torch.io.native_export import save_native_artifact
    from dfq_tpu_torch.models import init_params, mobilenet_v2, resnet18
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    device = resolve_device(args.device)
    graph = resnet18() if args.resnet else mobilenet_v2()
    if args.checkpoint:
        params = load_checkpoint(graph, args.checkpoint)
    else:
        print("WARNING: no --checkpoint given; using random weights")
        params = init_params(graph, seed=0, bn_stats="random")

    # ncnn-compatible regime: symmetric signed weights, 32-bit bias
    cfg = QuantConfig(
        quantize=True, relu=args.relu, equalize=args.equalize,
        absorption=args.absorption, correction=args.correction,
        clip_weight=args.clip_weight, signed=True, bits_bias=32,
    )
    prep = prepare(graph, params, cfg)
    model = lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model.layers}

    save_artifact(args.out, model, residual)
    save_native_artifact(args.out + "_native", model, residual)
    print(f"exported {args.out}/ and {args.out}_native.dfqparam/.dfqbin")
    out = {"model": model, "params": residual}

    if args.validate:
        from dfq_tpu_torch.engine.native import NativeModel

        nm = NativeModel(args.out + "_native")
        x = np.clip(np.random.default_rng(0).normal(0, 1, (2, 224, 224, 3)),
                    -2.117, 2.64).astype(np.float32)
        with torch.no_grad():
            ref = Int8Net(model, residual, device=device)(
                torch.from_numpy(x).to(device)).cpu().numpy()
        got = nm.forward(x)[0]
        agree = float((got.argmax(-1) == ref.argmax(-1)).mean())
        max_abs = float(np.abs(got - ref).max())
        print(f"native-vs-{device.type}: top1 agreement {agree}, max |diff| {max_abs:.4g}")
        if agree != 1.0:
            raise SystemExit("native runtime disagrees with the int8 engine")
        out.update(native=got, engine=ref, top1_agreement=agree, max_abs=max_abs)
    return out


if __name__ == "__main__":
    main()
