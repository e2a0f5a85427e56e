"""The ZeroQ standalone pipeline on the port (counterpart of
``dfq_tpu/cli/run_zeroq.py``, the reference's ``ZeroQ/uniform_test.py``):
distill calibration data from the BN statistics of the unfolded model,
set activation ranges by running the distilled batches, quantize weights
per output channel, evaluate W8A8 in the f32 fake-quant simulator.

Examples::

    python -m dfq_tpu_torch.cli.run_zeroq --model mobilenet_v2
    python -m dfq_tpu_torch.cli.run_zeroq --model resnet18 --device cpu \\
        --dis_batch_size 4 --dis_num_batch 1 --dis_max_iters 20 --image-size 64
    python -m dfq_tpu_torch.cli.run_zeroq --model resnet18 \\
        --checkpoint r18.pth --data-dir /data/imagenet/val

It runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np

from dfq_tpu_torch.calib import DistillConfig, calibrate_ranges, distill_data
from dfq_tpu_torch.cli.common import load_checkpoint


def get_argument(argv=None):
    p = argparse.ArgumentParser(description="ZeroQ W8A8 on the PyTorch port")
    p.add_argument("--model", choices=["mobilenet_v2", "resnet18"], default="mobilenet_v2")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--data-dir", type=str, default=None)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=128)
    p.add_argument("--bits_weight", type=int, default=8)
    p.add_argument("--bits_activation", type=int, default=8)
    p.add_argument("--dis_batch_size", type=int, default=32)
    p.add_argument("--dis_num_batch", type=int, default=4)
    p.add_argument("--dis_max_iters", type=int, default=1000,
                   help="cap on distillation Adam steps (smoke/testing)")
    p.add_argument("--image-size", type=int, default=224,
                   help="distillation + smoke-eval image size")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (cuda, or cpu)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    """Run the pipeline; returns what it computed (``act_ranges``, the
    ``forward``, and ``logits`` of the smoke images or ``acc``)."""
    args = get_argument(argv)

    import torch

    from dfq_tpu_torch.device import resolve_device
    from dfq_tpu_torch.graph import execute
    from dfq_tpu_torch.graph.executor import params_to
    from dfq_tpu_torch.models import init_params, mobilenet_v2, resnet18
    from dfq_tpu_torch.passes import fold_batchnorm, quantize_layer_weights

    device = resolve_device(args.device)
    graph = mobilenet_v2() if args.model == "mobilenet_v2" else resnet18()
    if args.checkpoint:
        params = load_checkpoint(graph, args.checkpoint)
    else:
        print("WARNING: no --checkpoint given; using random weights")
        params = init_params(graph, seed=0, bn_stats="random")

    # ZeroQ distills against the raw (unfolded) BN statistics
    dcfg = DistillConfig(batch_size=args.dis_batch_size, num_batch=args.dis_num_batch,
                         image_size=(args.image_size, args.image_size),
                         early_break_factor=1.0, max_iters=args.dis_max_iters,
                         device=str(device))
    batches = distill_data(graph, params, dcfg, verbose=True)

    # fold BN for inference, quantize weights per output channel, calibrate
    # the activation ranges on the distilled data
    gf, pf = fold_batchnorm(graph, params)
    pq = quantize_layer_weights(gf, pf, bits_weight=args.bits_weight, bits_bias=32,
                                per_channel=True)
    act_ranges = calibrate_ranges(gf, pq, batches, bits_act=args.bits_activation,
                                  device=device)
    sim_params = params_to(pq, device)

    def fwd(x):
        return execute(gf, sim_params, x, act_ranges=act_ranges,
                       bits_act=args.bits_activation, device=device)

    out = {"act_ranges": act_ranges, "forward": fwd, "acc": None}
    with torch.no_grad():
        if args.data_dir:
            from dfq_tpu_torch.data import imagenet_batches

            correct = total = 0
            for imgs, labels in imagenet_batches(args.data_dir, args.batch_size,
                                                 limit=args.limit):
                logits = fwd(torch.from_numpy(imgs).to(device)).cpu().numpy()
                correct += int((logits.argmax(-1) == labels).sum())
                total += len(labels)
            out["acc"] = correct / max(total, 1)
            print(f"Acc: {out['acc']}")
        else:
            x = np.random.default_rng(0).normal(
                0, 1, (8, args.image_size, args.image_size, 3)).astype(np.float32)
            logits = fwd(torch.from_numpy(x).to(device)).cpu().numpy()
            out["logits"] = logits
            print(f"smoke eval ok: logits {logits.shape}, "
                  f"finite={bool(np.isfinite(logits).all())}")
    return out


if __name__ == "__main__":
    main()
