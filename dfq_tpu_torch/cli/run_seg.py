"""Segmentation entry point of the port (counterpart of
``dfq_tpu/cli/run_seg.py``): DeepLab-v3+ MobileNetV2 (output stride 16,
21 classes) with the reference's flags (its ``main_seg.py``), engine
selection, artifact export and Pascal VOC mIOU.

Examples::

    python -m dfq_tpu_torch.cli.run_seg --quantize --relu --equalize --engine fused
    python -m dfq_tpu_torch.cli.run_seg --quantize --relu --equalize --engine int8 \\
        --checkpoint deeplab-mobilenet.pth.tar --data-dir /data/VOC2012

It runs on CUDA unless ``--device cpu`` is given. The per-pixel argmax is
taken on the device: only class ids reach the host. Without
``--data-dir`` it runs one seeded ``--crop-size`` image and prints the
output's shape.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from dfq_tpu_torch.calib import calibrate_ranges, distill_data
from dfq_tpu_torch.cli.common import add_dfq_flags, distill_config, engine_forward, load_checkpoint


def get_argument(argv=None):
    p = argparse.ArgumentParser(description="DFQ DeepLab-v3+ segmentation on the PyTorch port")
    add_dfq_flags(p)
    p.add_argument("--dis_batch_size", type=int, default=16)
    p.add_argument("--dis_num_batch", type=int, default=8)
    p.add_argument("--data-dir", type=str, default=None,
                   help="VOC2012 root (JPEGImages/SegmentationClass/...)")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--crop-size", type=int, default=513)
    return p.parse_args(argv)


def smoke_images(n: int = 1, size: int = 513) -> np.ndarray:
    """``n`` seeded normalized images, float32 NHWC."""
    rng = np.random.default_rng(0)
    return np.clip(rng.normal(0, 1, (n, size, size, 3)), -2.117, 2.64).astype(np.float32)


def main(argv=None) -> dict:
    """Run the entry point; returns what it computed (``output``, the
    logits of the smoke image, or ``mIOU``; the ``forward``; for the int8
    engines the lowered ``model`` and its residual f32 ``params``)."""
    args = get_argument(argv)

    import torch

    from dfq_tpu_torch.device import resolve_device
    from dfq_tpu_torch.models import deeplab_mobilenet_v2, init_params
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    device = resolve_device(args.device)
    graph = deeplab_mobilenet_v2(input_size=args.crop_size)
    if args.checkpoint:
        params = load_checkpoint(graph, args.checkpoint)
    else:
        print("WARNING: no --checkpoint given; using random weights")
        params = init_params(graph, seed=0, bn_stats="random")

    cfg = QuantConfig(
        quantize=args.quantize, relu=args.relu, equalize=args.equalize,
        absorption=args.absorption, correction=args.correction,
        clip_weight=args.clip_weight, distill_range=args.distill_range,
        bits_weight=args.bits_weight, bits_activation=args.bits_activation,
        bits_bias=args.bits_bias,
    )
    t0 = time.time()
    prep = prepare(graph, params, cfg)

    if args.distill_range and args.quantize:
        dcfg = distill_config(args, device, image_size=(args.crop_size, args.crop_size),
                              early_break_factor=0.2)
        batches = distill_data(prep.graph, prep.params_fp, dcfg, verbose=True)
        prep.act_ranges = calibrate_ranges(prep.graph, prep.params, batches, device=device)
    print(f"pipeline: {time.time() - t0:.1f}s")

    fwd, out = engine_forward(prep, cfg, args.engine, device, args.save_artifact)
    out["forward"] = fwd

    miou = None
    with torch.no_grad():
        if args.data_dir:
            from dfq_tpu_torch.data.voc import VOCSegmentation
            from dfq_tpu_torch.metrics import SegEvaluator

            ds = VOCSegmentation(args.data_dir, crop_size=args.crop_size)
            evaluator = SegEvaluator(ds.NUM_CLASSES)
            seen = 0
            for imgs, targets in ds.batches(args.batch_size):
                # class ids (H*W bytes an image) leave the device, not the
                # logits; torch.argmax takes the first max, as np.argmax
                logits = fwd(torch.from_numpy(imgs).to(device))
                pred = logits.argmax(-1).to(torch.uint8).cpu().numpy()
                evaluator.add_batch(targets, pred)
                seen += len(imgs)
                if args.limit and seen >= args.limit:
                    break
            miou = evaluator.mean_iou()
            print(f"mIOU: {miou}, pixel acc: {evaluator.pixel_accuracy()}")
        else:
            x = torch.from_numpy(smoke_images(size=args.crop_size)).to(device)
            logits = fwd(x)
            out["classes"] = logits.argmax(-1).to(torch.uint8).cpu().numpy()
            out["output"] = logits.cpu().numpy()
            print(f"smoke eval ok: output {out['output'].shape}, "
                  f"finite={bool(np.isfinite(out['output']).all())}")
    out["mIOU"] = miou

    if args.log:
        with open("seg_result.txt", "a+") as f:
            f.write(json.dumps({
                "quant": args.quantize, "relu": args.relu,
                "equalize": args.equalize, "absorption": args.absorption,
                "correction": args.correction, "clip": args.clip_weight,
                "distill_range": args.distill_range, "engine": args.engine,
                "device": str(device), "miou": miou,
            }) + "\n")
    return out


if __name__ == "__main__":
    main()
