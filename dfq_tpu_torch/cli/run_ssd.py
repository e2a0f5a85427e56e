"""Detection entry point of the port (counterpart of
``dfq_tpu/cli/run_ssd.py``): MobileNetV2 SSD-Lite at 300x300 with the
reference's flags (its ``main_ssd.py``), engine selection, artifact export
and Pascal VOC mAP.

Examples::

    python -m dfq_tpu_torch.cli.run_ssd --quantize --relu --equalize --engine fused --device-nms
    python -m dfq_tpu_torch.cli.run_ssd --quantize --relu --equalize --engine int8 \\
        --checkpoint mb2-ssd-lite.pth --data-dir /data/VOC2007 --2007_metric

It runs on CUDA unless ``--device cpu`` is given. Without ``--data-dir``
it runs 2 seeded 300x300 images through the engine and one through the
predictor (decode and NMS: on the host, or on the device with
``--device-nms``) and prints the outputs' shapes and the detections.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import defaultdict

import numpy as np

from dfq_tpu_torch.calib import calibrate_ranges, distill_data
from dfq_tpu_torch.cli.common import add_dfq_flags, distill_config, engine_forward, load_checkpoint


def get_argument(argv=None):
    p = argparse.ArgumentParser(description="DFQ SSD-Lite detection on the PyTorch port")
    add_dfq_flags(p)
    p.add_argument("--dis_batch_size", type=int, default=16)
    p.add_argument("--dis_num_batch", type=int, default=8)
    p.add_argument("--data-dir", type=str, default=None,
                   help="VOC root (Annotations/JPEGImages/ImageSets)")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--2007_metric", dest="metric_2007", action="store_true")
    p.add_argument("--device-nms", action="store_true",
                   help="box decode + per-class hard-NMS on the device "
                        "(detection.device_nms) instead of host numpy")
    p.add_argument("--iou_threshold", type=float, default=0.5)
    return p.parse_args(argv)


def smoke_images(n: int = 2, size: int = 300) -> np.ndarray:
    """``n`` seeded RGB images in [0, 255), float32 HWC."""
    return np.random.default_rng(0).uniform(0, 255, (n, size, size, 3)).astype(np.float32)


def eval_map(dataset, predictor, use_2007_metric, iou_threshold, limit=None):
    """VOC mAP evaluation (reference ``main_ssd.py:60-141,306-337``)."""
    from dfq_tpu_torch.detection import box_utils
    from dfq_tpu_torch.metrics import (
        compute_average_precision,
        compute_voc2007_average_precision,
    )

    n = len(dataset) if limit is None else min(limit, len(dataset))
    gt_by_class = defaultdict(dict)  # class -> image_id -> (boxes, difficult)
    det_by_class = defaultdict(list)  # class -> [(image_id, score, box)]
    for i in range(n):
        image_id, (gt_boxes, gt_labels, is_difficult) = dataset.get_annotation(i)
        for cls in np.unique(gt_labels):
            mask = gt_labels == cls
            gt_by_class[int(cls)][image_id] = (gt_boxes[mask], is_difficult[mask])
        image = dataset.get_image(i)
        boxes, labels, probs = predictor.predict(image)
        for b, l, s in zip(boxes, labels, probs):
            det_by_class[int(l)].append((image_id, float(s), b))

    aps = []
    for cls in range(1, len(dataset.class_names)):
        gts = gt_by_class.get(cls, {})
        num_true = sum(int((1 - d).sum()) for _, d in gts.values())
        dets = sorted(det_by_class.get(cls, []), key=lambda t: -t[1])
        if num_true == 0 or not dets:
            if num_true > 0:
                aps.append(0.0)
            continue
        matched = set()
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for di, (image_id, score, box) in enumerate(dets):
            if image_id not in gts:
                fp[di] = 1
                continue
            gt_boxes, difficult = gts[image_id]
            ious = box_utils.iou_of(gt_boxes, box[None, :])
            best = int(np.argmax(ious))
            if ious[best] >= iou_threshold:
                if difficult[best]:
                    continue  # difficult boxes are ignored
                key = (image_id, best)
                if key not in matched:
                    matched.add(key)
                    tp[di] = 1
                else:
                    fp[di] = 1
            else:
                fp[di] = 1
        tp_c = np.cumsum(tp)
        fp_c = np.cumsum(fp)
        precision = tp_c / np.maximum(tp_c + fp_c, 1e-12)
        recall = tp_c / num_true
        if use_2007_metric:
            aps.append(compute_voc2007_average_precision(precision, recall))
        else:
            aps.append(compute_average_precision(precision, recall))
    return float(np.mean(aps)) if aps else 0.0, aps


def main(argv=None) -> dict:
    """Run the entry point; returns what it computed (``conf``/``loc`` of
    the smoke images and one image's ``detections``, or ``mAP``; the
    ``forward``, the ``predictor``; for the int8 engines the lowered
    ``model`` and its residual f32 ``params``)."""
    args = get_argument(argv)

    import torch

    from dfq_tpu_torch.detection.predictor import Predictor
    from dfq_tpu_torch.device import resolve_device
    from dfq_tpu_torch.models import init_params, mobilenet_v2_ssd_lite
    from dfq_tpu_torch.models.ssd import SSDConfig, quantized_priors
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    device = resolve_device(args.device)
    graph = mobilenet_v2_ssd_lite(num_classes=21)
    config = SSDConfig()
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
        bits_bias=args.bits_bias, delete_single=True, is_detection=True,
    )
    t0 = time.time()
    prep = prepare(graph, params, cfg)

    if args.distill_range and args.quantize:
        dcfg = distill_config(args, device, image_size=(300, 300), value_range=(-1.0, 1.0),
                              max_value=1.0, early_break_factor=0.04)
        batches = distill_data(prep.graph, prep.params_fp, dcfg, verbose=True)
        prep.act_ranges = calibrate_ranges(prep.graph, prep.params, batches, is_detection=True,
                                           device=device)
    print(f"pipeline: {time.time() - t0:.1f}s")

    fwd, out = engine_forward(prep, cfg, args.engine, device, args.save_artifact)
    out["forward"] = fwd

    def forward_np(x):
        return fwd(torch.from_numpy(x).to(device))

    # the reference fake-quantizes the prior boxes when quantizing
    # (mobilenet_v2_ssd_lite.py:57-59)
    priors = quantized_priors(config) if args.quantize else config.priors
    predictor = Predictor(forward_np, config, priors=priors, device_nms=args.device_nms)
    out["predictor"] = predictor

    mean_ap = None
    with torch.no_grad():
        if args.data_dir:
            from dfq_tpu_torch.data.voc import VOCDetection

            ds = VOCDetection(args.data_dir, split_file=args.split)
            mean_ap, aps = eval_map(
                ds, predictor, args.metric_2007, args.iou_threshold, args.limit
            )
            print(f"mAP: {mean_ap}")
            for name, ap in zip(ds.class_names[1:], aps):
                print(f"  {name}: {ap:.4f}")
        else:
            images = smoke_images()
            x = np.concatenate([predictor.preprocess(im) for im in images])
            conf, loc = (t.cpu().numpy() for t in forward_np(x))
            boxes, labels, probs = predictor.predict(images[0])
            out.update(conf=conf, loc=loc, detections=(boxes, labels, probs))
            print(f"smoke eval ok: conf {conf.shape}, loc {loc.shape}, "
                  f"finite={bool(np.isfinite(conf).all() and np.isfinite(loc).all())}, "
                  f"detections {len(labels)} ({'device' if predictor.device_nms else 'host'} NMS)")
    out["mAP"] = mean_ap

    if args.log:
        with open("ssd_result.txt", "a+") as f:
            f.write(json.dumps({
                "quant": args.quantize, "relu": args.relu,
                "equalize": args.equalize, "absorption": args.absorption,
                "correction": args.correction, "clip": args.clip_weight,
                "distill_range": args.distill_range, "engine": args.engine,
                "2007": args.metric_2007, "device": str(device), "mAP": mean_ap,
            }) + "\n")
    return out


if __name__ == "__main__":
    main()
