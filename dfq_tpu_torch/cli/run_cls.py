"""Classification entry point of the port (counterpart of
``dfq_tpu/cli/run_cls.py``): the reference's flags (its
``main_cls.py:23-41``), engine selection and artifact export.

Examples::

    python -m dfq_tpu_torch.cli.run_cls --quantize --relu --equalize --correction
    python -m dfq_tpu_torch.cli.run_cls --resnet --quantize --relu --equalize \\
        --engine fused --save-artifact out/r18_int8
    python -m dfq_tpu_torch.cli.run_cls --quantize --relu --equalize \\
        --engine int8 --checkpoint mobilenetv2.pth --data-dir /data/imagenet/val
    python -m dfq_tpu_torch.cli.run_cls --quantize --relu --equalize \\
        --engine fused --save-artifact out/mnv2 --aot-batch 128

With ``--quantize --distill_range`` the activation ranges come from
ZeroQ calibration (``dfq_tpu_torch.calib``): batches distilled from the
model's BN statistics, or with ``--true_data`` the first
``--dis_batch_size * --dis_num_batch`` images of ``--data-dir``.

It runs on CUDA unless ``--device cpu`` is given. ``--engine sim`` is the
f32 fake-quant simulator (``dfq_tpu_torch.graph.execute``), ``int8`` the
baseline int8 engine (``Int8Net``), ``fused`` the fused engine on the
hand-written kernels (``Int8FusedNet``). Without ``--data-dir`` it runs
8 seeded 224x224 images and prints the logits' shape; with it,
``--stream`` keeps two batches in flight (``dfq_tpu_torch.parallel.stream``).
``--aot-batch B`` (with ``--engine fused --save-artifact DIR``, on the
card) ships the kernel libraries the forward ran in ``DIR/aot/``; reload
with ``dfq_tpu_torch.io.aot.load_aot_forward(DIR)``, which needs no
``nvcc``.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from dfq_tpu_torch.calib import calibrate_ranges, distill_data
from dfq_tpu_torch.io import aot
from dfq_tpu_torch.cli.common import (
    add_dfq_flags,
    distill_config,
    engine_forward,
    load_checkpoint,
)


def get_argument(argv=None):
    p = argparse.ArgumentParser(description="DFQ classification on the PyTorch port")
    add_dfq_flags(p)
    p.add_argument("--trainable", action="store_true",
                   help="per-forward weight fake-quant regime (reference QuantConv2d)")
    p.add_argument("--resnet", action="store_true")
    p.add_argument("--dis_batch_size", type=int, default=64)
    p.add_argument("--dis_num_batch", type=int, default=8)
    p.add_argument("--true_data", action="store_true",
                   help="calibrate ranges from real images in --data-dir")
    p.add_argument("--data-dir", type=str, default=None,
                   help="ImageNet val directory (folder-per-class)")
    p.add_argument("--limit", type=int, default=None, help="max val images")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--aot-batch", type=int, default=0)
    p.add_argument("--stream", action="store_true")
    p.add_argument("--signed", action="store_true",
                   help="symmetric weight quant (Int8' regime)")
    return p.parse_args(argv)


def build_model(args):
    from dfq_tpu_torch.models import init_params, mobilenet_v2, resnet18

    graph = resnet18() if args.resnet else mobilenet_v2()
    if args.checkpoint:
        params = load_checkpoint(graph, args.checkpoint)
    else:
        print("WARNING: no --checkpoint given; using random weights")
        params = init_params(graph, seed=0, bn_stats="random")
    return graph, params


def main(argv=None) -> dict:
    """Run the entry point; returns what it computed (``logits`` of the
    smoke images or ``acc``, the ``forward`` module, and for the int8
    engines the lowered ``model`` and its residual f32 ``params``)."""
    args = get_argument(argv)
    if args.aot_batch and not (args.quantize and args.engine == "fused" and args.save_artifact):
        raise SystemExit("--aot-batch ships the fused engine's kernels in the artifact: it "
                         "needs --quantize --engine fused --save-artifact DIR")

    import torch

    from dfq_tpu_torch.device import resolve_device
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    device = resolve_device(args.device)
    if args.aot_batch:
        try:
            aot.current_meta(device)
        except ValueError as e:
            raise SystemExit(f"--aot-batch: {e}") from None
    graph, params = build_model(args)
    cfg = QuantConfig(
        quantize=args.quantize, relu=args.relu, equalize=args.equalize,
        absorption=args.absorption, correction=args.correction,
        clip_weight=args.clip_weight, distill_range=args.distill_range,
        trainable=args.trainable, bits_weight=args.bits_weight,
        bits_activation=args.bits_activation, bits_bias=args.bits_bias, signed=args.signed,
    )
    t0 = time.time()
    prep = prepare(graph, params, cfg)

    if args.distill_range and args.quantize:
        if args.true_data:
            if not args.data_dir:
                raise SystemExit("--true_data requires --data-dir")
            from dfq_tpu_torch.data import imagenet_batches

            batches = [imgs for imgs, _ in imagenet_batches(
                args.data_dir, args.dis_batch_size,
                limit=args.dis_batch_size * args.dis_num_batch)]
        else:
            dcfg = distill_config(args, device, early_break_factor=1.2 if args.resnet else 0.5)
            batches = distill_data(prep.graph, prep.params_fp, dcfg, verbose=True)
        prep.act_ranges = calibrate_ranges(prep.graph, prep.params, batches, device=device)
    print(f"pipeline: {time.time() - t0:.1f}s")

    fwd, out = engine_forward(prep, cfg, args.engine, device, args.save_artifact)
    out["forward"] = fwd
    if args.aot_batch:
        # the kernel libraries the forward ran, in the artifact: a process
        # on a matching card starts from it with no nvcc (io/aot.py)
        aot.save_aot_forward(args.save_artifact, fwd, args.aot_batch, 224)
        print(f"AOT kernels (batch {args.aot_batch}) saved into the artifact")

    acc = None
    with torch.no_grad():
        if args.data_dir:
            from dfq_tpu_torch.data import imagenet_batches

            batches = imagenet_batches(args.data_dir, args.batch_size, limit=args.limit)
            if args.stream:
                # keep batches in flight: host decode and the copy to the
                # device overlap the device's forward (parallel/stream.py)
                from dfq_tpu_torch.parallel.mesh import to_device
                from dfq_tpu_torch.parallel.stream import stream_counters

                def step(imgs, labels):
                    logits = fwd(to_device(imgs, device))
                    return (logits.argmax(-1) == to_device(labels, device)).sum()

                correct, total = stream_counters(step, batches)
            else:
                correct = total = 0
                for imgs, labels in batches:
                    logits = fwd(torch.from_numpy(imgs).to(device)).cpu().numpy()
                    correct += int((logits.argmax(-1) == labels).sum())
                    total += len(labels)
            acc = correct / max(total, 1)
            out["counts"] = (correct, total)
            print(f"Acc: {acc}")
        else:
            x = np.random.default_rng(0).normal(0, 1, (8, 224, 224, 3)).astype(np.float32)
            logits = fwd(torch.from_numpy(x).to(device)).cpu().numpy()
            out["logits"] = logits
            print(f"smoke eval ok: logits shape {logits.shape}, "
                  f"finite={bool(np.isfinite(logits).all())}")
    out["acc"] = acc

    if args.log:
        with open("cls_result.txt", "a+") as f:
            f.write(json.dumps({
                "resnet": args.resnet, "quant": args.quantize, "relu": args.relu,
                "equalize": args.equalize, "absorption": args.absorption,
                "correction": args.correction, "clip": args.clip_weight,
                "distill_range": args.distill_range, "engine": args.engine,
                "device": str(device), "acc": acc,
            }) + "\n")
    return out


if __name__ == "__main__":
    main()
