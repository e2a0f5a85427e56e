"""High-bias absorption.

Behavioral contract: reference ``bias_absorption``
(``dfq.py:121-164``): for each equalization relation whose
path first->second crosses a ReLU, compute per-channel
``c = clamp(stat_mean - N * stat_std, min=0)`` (N=3) from the BN between
the pair, then shift: ``b1 -= c``, ``bn.stat_mean -= c``,
``b2 += sum_spatial(W2) @ c`` (group-aware). This moves the part of the
bias that ReLU would pass through anyway into the next layer, shrinking
activation ranges.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from .ir import Graph
from .relations import Relation


def _relu_between(graph: Graph, first: str, second: str) -> bool:
    # walk up the (1-to-1) chain from second to first (reference dfq.py:123-130)
    idx = second
    while idx != first:
        bots = graph.bottoms(idx)
        assert len(bots) == 1, "equalization relation path must be 1-to-1"
        if graph[bots[0]].op == "relu":
            return True
        idx = bots[0]
    return False


def bias_absorption(
    graph: Graph,
    params: Dict[str, Dict[str, Any]],
    relations: List[Relation],
    N: float = 3.0,
) -> Dict[str, Dict[str, Any]]:
    params = {k: dict(v) for k, v in params.items()}
    for rel in relations:
        if rel.bn is None or not _relu_between(graph, rel.first, rel.second):
            continue
        bn_p = dict(params[rel.bn])
        std = np.asarray(bn_p["stat_std"], np.float32)
        mean = np.asarray(bn_p["stat_mean"], np.float32)
        c = np.maximum(mean - N * std, 0.0).astype(np.float32)
        if not np.any(c):
            continue

        p1 = dict(params[rel.first])
        p2 = dict(params[rel.second])
        w2 = np.asarray(p2["weight"], np.float32)
        o1 = np.asarray(p1["weight"], np.float32).shape[0]
        num_group = o1 // w2.shape[1]
        go = w2.shape[0] // num_group
        gi = o1 // num_group

        # wc[o] = sum_spatial(W2)[o, :] @ c[group(o)]   (reference dfq.py:154-157)
        w2s = w2.reshape(w2.shape[0], w2.shape[1], -1).sum(-1)
        wc = np.zeros(w2.shape[0], np.float32)
        for g in range(num_group):
            wc[g * go : (g + 1) * go] = w2s[g * go : (g + 1) * go] @ c[
                g * gi : (g + 1) * gi
            ]

        b1 = p1.get("bias")
        b1 = np.zeros(o1, np.float32) if b1 is None else np.asarray(b1, np.float32)
        p1["bias"] = (b1 - c).astype(np.float32)
        bn_p["stat_mean"] = (mean - c).astype(np.float32)
        b2 = p2.get("bias")
        b2 = (
            np.zeros(w2.shape[0], np.float32)
            if b2 is None
            else np.asarray(b2, np.float32)
        )
        p2["bias"] = (b2 + wc).astype(np.float32)

        params[rel.first] = p1
        params[rel.second] = p2
        params[rel.bn] = bn_p
    return params
