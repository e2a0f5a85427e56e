"""ZeroQ reconstruction-variant calibration data (port of
``dfq_tpu/calib/recon.py``, the reference's ``getReconData``,
``ZeroQ/reconstruct_data.py:53-161``): the synthesis that hooks the conv
outputs feeding each BN.

- targets are the raw BN running statistics ``(mean, sqrt(var + 1e-6))``;
  folded BNs keep their retained stat buffers;
- no value-range clamp on the image (unlike ``getDistilData``);
- loss = the BN-statistics loss plus the input statistics vs N(0,1),
  normalized by batch;
- Adam lr 0.1, ReduceLROnPlateau(patience=100, min_lr=1e-4), 500 iters,
  early break at ``loss <= (num_BN + 1) * 5``.

The simulator's pre-BN conv output is the BN input, so
``capture="bn_inputs"`` supplies the hooked statistics; the loop is
:mod:`dfq_tpu_torch.calib.distill`'s. Unused by the reference's entry
scripts; kept for parity with the ZeroQ subtree.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from dfq_tpu_torch.calib.distill import (
    DistillConfig,
    bn_statistics_loss,
    init_random_batch,
    optimize_batch,
)
from dfq_tpu_torch.graph.ir import Graph


@dataclasses.dataclass
class ReconConfig:
    batch_size: int = 32
    num_batch: int = 1
    image_size: tuple = (224, 224)
    max_value: float = 1.0
    max_iters: int = 500
    lr: float = 0.1
    plateau_patience: int = 100
    plateau_factor: float = 0.1
    min_lr: float = 1e-4
    early_break: float = 5.0
    device: Optional[str] = None  # None: CUDA


def _bn_raw_targets(graph: Graph, params):
    """Raw BN running stats; folded BNs keep their retained stat buffers."""
    targets = {}
    for node in graph:
        if node.op == "bn":
            p = params[node.name]
            targets[node.name] = (np.asarray(p["mean"], np.float32),
                                  np.sqrt(np.asarray(p["var"], np.float32) + 1e-6))
        elif node.op in ("identity", "dropout") and "stat_std" in params.get(node.name, {}):
            p = params[node.name]
            targets[node.name] = (np.asarray(p["stat_mean"], np.float32),
                                  np.asarray(p["stat_std"], np.float32))
    return targets


def recon_batch_fn(graph: Graph, params, cfg: ReconConfig):
    """The per-batch synthesis ``x0 -> (images, steps, last loss)`` (images
    unclipped, on the device)."""
    targets = _bn_raw_targets(graph, params)
    loss_fn = bn_statistics_loss(graph, params, targets, device=cfg.device)
    threshold = (len(targets) + 1) * cfg.early_break

    def run(x0):
        return optimize_batch(loss_fn, x0, lr=cfg.lr, max_iters=cfg.max_iters,
                              threshold=threshold, patience=cfg.plateau_patience,
                              factor=cfg.plateau_factor, min_lr=cfg.min_lr, device=cfg.device)

    return run


def recon_data(graph: Graph, params, cfg: Optional[ReconConfig] = None, seed: int = 0,
               verbose: bool = False) -> List[np.ndarray]:
    """Synthesize ``cfg.num_batch`` reconstruction batches (host arrays)."""
    cfg = cfg or ReconConfig()
    rng = np.random.default_rng(seed)
    run = recon_batch_fn(graph, params, cfg)
    seed_cfg = DistillConfig(batch_size=cfg.batch_size, image_size=cfg.image_size,
                             max_value=cfg.max_value)
    batches = []
    for i in range(cfg.num_batch):
        x, it, loss = run(init_random_batch(rng, seed_cfg))
        if verbose:
            print(f"recon batch {i + 1}/{cfg.num_batch}: iters={it} loss={loss:.3f}")
        batches.append(x.cpu().numpy())
    return batches
