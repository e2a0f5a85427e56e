"""Sharded distilled-data synthesis (port of ``dfq_tpu/parallel/calib.py``).

ZeroQ distillation is the only gradient computation in the DFQ pipeline
(``ZeroQ/distill_data.py:172-216``; the reference is single-GPU). The
synthesized image batch is split over the mesh's data axis. The BN-
statistics loss is a sum over per-sample statistics, and its input-
statistics term divides by the whole batch's size, so each shard's loss
is its share of the whole batch's and its gradient (by autograd, on the
shard's device) is the whole loss's gradient at its images. Adam is
element-wise, so each shard steps on its own; the step's loss is the sum
of the shards' losses. The optimizer is plain ``optax.adam(cfg.lr)``, as
in the JAX package's sharded step (not the ``inject_hyperparams`` form of
``calib/distill.py``'s loop).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dfq_tpu_torch.calib.distill import (
    AdamState,
    DistillConfig,
    adam_step,
    loss_and_grad,
    make_loss_fn,
)
from dfq_tpu_torch.graph.ir import Graph
from dfq_tpu_torch.parallel.eval import on_device
from dfq_tpu_torch.parallel.mesh import Mesh, Sharded, shard_batch


def make_sharded_distill_step(graph: Graph, params, cfg: DistillConfig, mesh: Mesh):
    """Returns ``(step, init)``: ``init(x0) -> (x, opt_state)`` places the
    seed batch on the mesh (a :class:`Sharded` batch and one Adam state a
    shard), and ``step(x, opt_state) -> (x', opt_state', loss)`` takes one
    Adam step on every shard (``opt_state`` updated in place; ``loss`` a
    0-d f32 tensor on the first shard's device)."""
    loss_fns = {d: make_loss_fn(graph, params, dataclasses.replace(cfg, device=str(d)))[0]
                for d in mesh.distinct()}

    def init(x0):
        x0 = x0 if isinstance(x0, torch.Tensor) else torch.from_numpy(np.asarray(x0))
        x = shard_batch(mesh, x0.to(torch.float32))
        return x, [AdamState.init(s, cfg.lr, injected=False) for s in x.shards]

    def step(x: Sharded, opt_state):
        batch = sum(s.shape[0] for s in x.shards)
        home = x.devices[0]
        new, losses = [], []
        for s, st, d in zip(x.shards, opt_state, x.devices):
            with on_device(d):
                loss, grad = loss_and_grad(
                    lambda v, f=loss_fns[d]: f(v, batch_size=batch), s)
                with torch.no_grad():
                    new.append(adam_step(s, grad, st))
            losses.append(loss.to(home))
        return Sharded(new, x.devices), opt_state, sum(losses[1:], losses[0])

    return step, init
