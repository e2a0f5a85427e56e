"""Cross-layer (weight-range) equalization — vectorized.

Behavioral contract: reference ``_layer_equalization`` /
``cross_layer_equalization`` (``dfq.py:28-119``):

for each relation (W1, W2) and each input channel i of W2 (group-aware):
    r1 = range of W1's output-channel-i filter   (max-min, or max|.|)
    r2 = range of W2's column i                  (same metric)
    s  = (1/r1) * sqrt(r1*r2), clipped to s_range
    W1[i] *= s;  b1[i] *= s;  bn_stats[i] *= s;  W2[:, i] /= s

iterated until the summed mean |dW| change stabilizes below
``converge_thres`` for ``converge_count`` rounds.

The reference runs an O(pairs * C) Python loop per sweep
(``dfq.py:48-73``); channels are independent so here each pair updates
with a handful of whole-tensor numpy reductions per sweep.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from dfq_tpu_torch.graph.ir import Graph
from dfq_tpu_torch.passes.relations import Relation


def _pair_scales(
    w1: np.ndarray, w2: np.ndarray, s_range: Tuple[float, float], signed: bool
) -> np.ndarray:
    """Per-channel scale vector S (length = w1 out channels), group-aware."""
    o1 = w1.shape[0]
    i2 = w2.shape[1]
    num_group = o1 // i2 if o1 != i2 else 1
    go = w2.shape[0] // num_group

    f1 = w1.reshape(o1, -1)
    if signed:
        r1 = np.abs(f1).max(axis=1)
    else:
        r1 = f1.max(axis=1) - f1.min(axis=1)

    # w2 grouped: [G, go, i2, spatial...] -> range over (go, spatial) per (G, i2)
    w2g = w2.reshape(num_group, go, i2, -1)
    if signed:
        r2 = np.abs(w2g).max(axis=(1, 3))
    else:
        r2 = w2g.max(axis=(1, 3)) - w2g.min(axis=(1, 3))
    r2 = r2.reshape(o1)

    s = (1.0 / r1) * np.sqrt(r1 * r2)
    return np.clip(s, s_range[0], s_range[1]).astype(np.float32)


def _apply_pair(
    p1: Dict[str, Any],
    p2: Dict[str, Any],
    bn_p: Dict[str, Any],
    s: np.ndarray,
) -> None:
    w1 = p1["weight"]
    shape1 = (-1,) + (1,) * (w1.ndim - 1)
    p1["weight"] = (w1 * s.reshape(shape1)).astype(np.float32)
    if p1.get("bias") is not None:
        p1["bias"] = (p1["bias"] * s).astype(np.float32)
    if bn_p is not None:
        bn_p["stat_std"] = (bn_p["stat_std"] * s).astype(np.float32)
        bn_p["stat_mean"] = (bn_p["stat_mean"] * s).astype(np.float32)

    w2 = p2["weight"]
    o1 = s.shape[0]
    i2 = w2.shape[1]
    num_group = o1 // i2 if o1 != i2 else 1
    go = w2.shape[0] // num_group
    w2g = w2.reshape(num_group, go, i2, -1)
    sg = s.reshape(num_group, 1, i2, 1)
    p2["weight"] = (w2g / sg).reshape(w2.shape).astype(np.float32)


def cross_layer_equalization(
    graph: Graph,
    params: Dict[str, Dict[str, Any]],
    relations: List[Relation],
    *,
    s_range: Tuple[float, float] = (1e-8, 1e8),
    converge_thres: float = 2e-7,
    converge_count: int = 20,
    signed: bool = False,
    max_iters: int = 1000,
) -> Dict[str, Dict[str, Any]]:
    """Returns new params; also accumulates each relation's scale vector."""
    params = {k: dict(v) for k, v in params.items()}
    targ = sorted({r.first for r in relations} | {r.second for r in relations})

    # ensure first layers have bias terms (reference dfq.py:91-92)
    for rel in relations:
        for name in (rel.first, rel.second):
            p = params[name]
            if p.get("bias") is None:
                p["bias"] = np.zeros(p["weight"].shape[0], np.float32)

    diff = 10.0
    count = 0
    iters = 0
    while diff > converge_thres and count < converge_count and iters < max_iters:
        state_prev = {k: params[k]["weight"].copy() for k in targ}
        for rel in relations:
            p1, p2 = params[rel.first], params[rel.second]
            bn_p = params[rel.bn] if rel.bn is not None else None
            s = _pair_scales(p1["weight"], p2["weight"], s_range, signed)
            _apply_pair(p1, p2, bn_p, s)
            rel.accumulate_scale(s)

        diff_tmp = sum(
            float(np.mean(np.abs(params[k]["weight"] - state_prev[k]))) for k in targ
        )
        if abs(diff - diff_tmp) > 1e-9:
            count = 0
            diff = diff_tmp
        else:
            count += 1
        iters += 1
    return params
