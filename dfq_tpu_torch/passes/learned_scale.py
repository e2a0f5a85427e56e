"""Learned equalization scales (port of ``dfq_tpu/passes/learned_scale.py``,
the reference's ``update_scale`` experiment, ``improve_dfq.py:193-278``).

It refines cross-layer-equalization scales by gradient descent:

- one learnable per-channel scale vector per relation, applied as
  ``W1 * s`` (rows) / ``b1 * s`` / ``W2 / s`` (columns, group-aware);
- loss = ``KL(fp32_logits || quantized_logits)`` per distilled batch
  (``kl_categorical``), Adam lr 1e-3;
- after every step the BN stat buffers are rescaled by the current scales
  and the data-free ranges re-derived on the host
  (:func:`~dfq_tpu_torch.passes.range_setter.set_quant_ranges`);
- early stop when loss < 0.02.

The scales are leaf tensors with ``requires_grad``; the scaled,
weight-fake-quantized forward is the simulator, differentiated by
``torch.autograd``, with the straight-through estimator on the weight
rounding (``x + (fq(x) - x).detach()``, the JAX package's
``stop_gradient`` form). The Adam step is optax's
(:func:`~dfq_tpu_torch.calib.distill.adam_step`). The reference's
``GradHook`` mask is a no-op in its shipped code, so none is applied.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from dfq_tpu_torch.calib.distill import AdamState, adam_step
from dfq_tpu_torch.device import resolve_device
from dfq_tpu_torch.graph.executor import execute, highest_precision, params_to
from dfq_tpu_torch.graph.ir import Graph
from dfq_tpu_torch.passes.range_setter import set_quant_ranges
from dfq_tpu_torch.passes.relations import Relation
from dfq_tpu_torch.quant.core import fake_quant


def _fq_ste(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-tensor min/max fake-quant, straight-through in the backward."""
    y = fake_quant(x, x.min(), x.max(), bits=bits)
    return x + (y - x).detach()


def _grouped(s, w2_shape):
    """``s`` shaped to divide the columns of a (possibly grouped) second
    layer: ``(groups, 1, in per group, 1...)`` and the grouped weight shape."""
    o1, i2 = s.shape[0], w2_shape[1]
    num_group = o1 // i2 if o1 != i2 else 1
    go = w2_shape[0] // num_group
    tail = tuple(w2_shape[2:])
    return s.reshape((num_group, 1, i2) + (1,) * len(tail)), (num_group, go, i2) + tail


def _apply_scales(params, relations: Sequence[Relation], scales: List[torch.Tensor]):
    """Differentiable ``equalize._apply_pair`` over device params."""
    out = dict(params)

    def upd(name):
        if out[name] is params[name]:
            out[name] = dict(params[name])
        return out[name]

    for rel, s in zip(relations, scales):
        p1 = upd(rel.first)
        w1 = p1["weight"]
        p1["weight"] = w1 * s.reshape((-1,) + (1,) * (w1.ndim - 1))
        if p1.get("bias") is not None:
            p1["bias"] = p1["bias"] * s
        p2 = upd(rel.second)
        w2 = p2["weight"]
        sg, gshape = _grouped(s, tuple(w2.shape))
        p2["weight"] = (w2.reshape(gshape) / sg).reshape(w2.shape)
    return out


def _kl_categorical(p_logit: torch.Tensor, q_logit: torch.Tensor) -> torch.Tensor:
    """KL(softmax(p) || softmax(q)), summed then batch-normalized."""
    p = torch.softmax(p_logit, dim=-1)
    kl = torch.sum(p * (torch.log_softmax(p_logit, dim=-1) - torch.log_softmax(q_logit, dim=-1)))
    return kl / p_logit.shape[0]


def learn_scales(
    graph: Graph,
    params: Dict[str, Dict[str, Any]],
    relations: Sequence[Relation],
    batches: Sequence[np.ndarray],
    *,
    num_epoch: int = 10,
    lr: float = 1e-3,
    bits_w: int = 8,
    bits_act: int = 8,
    is_detection: bool = False,
    loss_break: float = 0.02,
    verbose: bool = False,
    device=None,
) -> Tuple[Dict[str, Dict[str, Any]], Dict[str, Tuple[float, float]], List[float]]:
    """Refine equalization scales on distilled data.

    ``params`` must be BN-folded (stat buffers present). Returns
    ``(merged_params, act_ranges, loss_history)``: the scales merged into
    the weights (host numpy), plus the final data-free ranges.
    """
    dev = resolve_device(device)
    targets = sorted({r.first for r in relations} | {r.second for r in relations})
    dev_params = params_to(params, dev)

    def q_forward(scales, x, act_ranges):
        p = _apply_scales(dev_params, relations, scales)
        # per-forward weight fake-quant with its current min/max
        for name in targets:
            q = dict(p[name])
            q["weight"] = _fq_ste(q["weight"], bits_w)
            p[name] = q
        return execute(graph, p, x, act_ranges=act_ranges, bits_act=bits_act, device=dev)

    scales = [torch.ones(params[r.first]["weight"].shape[0], dtype=torch.float32, device=dev)
              for r in relations]
    states = [AdamState.init(s, lr) for s in scales]

    def derive_ranges(scales_np):
        # rescale the stat buffers, then rerun the closed-form range pass
        p = copy.deepcopy(params)
        for rel, s in zip(relations, scales_np):
            if rel.bn is not None:
                p[rel.bn]["stat_std"] = (p[rel.bn]["stat_std"] * s).astype(np.float32)
                p[rel.bn]["stat_mean"] = (p[rel.bn]["stat_mean"] * s).astype(np.float32)
        return set_quant_ranges(graph, p, is_detection=is_detection)

    def host(ss):
        return [s.detach().cpu().numpy() for s in ss]

    act_ranges = derive_ranges(host(scales))
    history: List[float] = []
    stop = False
    for epoch in range(num_epoch):
        for x in batches:
            xb = torch.as_tensor(np.asarray(x, np.float32)).to(dev)
            with torch.no_grad():
                fp_logit = execute(graph, dev_params, xb, device=dev)
            leaves = [s.requires_grad_(True) for s in scales]
            with highest_precision():  # the backward too
                loss = _kl_categorical(fp_logit, q_forward(leaves, xb, act_ranges))
                grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                scales = [adam_step(s.detach(), g, st) for s, g, st in zip(leaves, grads, states)]
            act_ranges = derive_ranges(host(scales))
            history.append(float(loss.detach()))
            if verbose:
                print(f"epoch {epoch + 1} loss {history[-1]:.4f}")
            if history[-1] < loss_break:
                stop = True
                break
        if stop:
            break

    merged = copy.deepcopy(params)
    for rel, s in zip(relations, host(scales)):
        s = s.astype(np.float32)
        p1 = merged[rel.first]
        p1["weight"] = (p1["weight"] * s.reshape((-1,) + (1,) * (p1["weight"].ndim - 1))
                        ).astype(np.float32)
        if p1.get("bias") is not None:
            p1["bias"] = (p1["bias"] * s).astype(np.float32)
        if rel.bn is not None:
            merged[rel.bn]["stat_std"] = (merged[rel.bn]["stat_std"] * s).astype(np.float32)
            merged[rel.bn]["stat_mean"] = (merged[rel.bn]["stat_mean"] * s).astype(np.float32)
        p2 = merged[rel.second]
        w2 = p2["weight"]
        sg, gshape = _grouped(s, w2.shape)
        p2["weight"] = (w2.reshape(gshape) / sg).reshape(w2.shape).astype(np.float32)
        rel.accumulate_scale(s)
    return merged, derive_ranges(host(scales)), history
