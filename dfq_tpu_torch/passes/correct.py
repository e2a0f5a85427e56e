"""Data-free bias correction.

Behavioral contract: reference ``bias_correction``
(``dfq.py:173-293``): for every target layer,

1. quantization error ``eps[o, i] = sum_spatial(Q(W) - W)`` with
   per-tensor weight fake-quant (``dfq.py:218-219``),
2. expected input per channel ``E[x]`` from the preceding BN statistics —
   ``E[ReLU(N(mu, sd^2))]`` via the rectified-Gaussian closed form when a
   plain ReLU follows the BN, else ``mu`` (``dfq.py:239-242``; ReLU6 is
   deliberately NOT rectified here, matching the reference which only
   tracks ``nn.ReLU``), with add branches summing expectations and concat
   branches concatenating (``dfq.py:266-270``),
3. ``bias -= eps @ E[x]`` (group-aware, ``dfq.py:281-287``), and
4. the correction is propagated into the layer's *following* BN
   ``stat_mean`` so downstream expectations/ranges see the shifted output
   distribution (``dfq.py:204-206,293``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from dfq_tpu_torch.graph.ir import Graph
from dfq_tpu_torch.passes.bn_walk import find_prev_bn
from dfq_tpu_torch.quant.core import fake_quant_np
from dfq_tpu_torch.quant.moments import relu_gaussian_mean

_TARGET = {"conv", "linear"}


def _weight_quant_error(w: np.ndarray, bits: int, signed: bool) -> np.ndarray:
    q = fake_quant_np(w, float(w.min()), float(w.max()), bits=bits, symmetric=signed)
    eps = q - w
    return eps.reshape(w.shape[0], w.shape[1], -1).sum(-1)  # [O, I/g]


def _branch_expectation(params, entries, relu_flags) -> np.ndarray:
    """Merge one branch's BN hits into E[x] (reference dfq.py:229-275)."""
    tmp = sorted(entries, key=lambda e: len(e[0][1]), reverse=True)
    (bn_name, bid), use_relu, connect_type = tmp[0]
    depth = len(bid)
    tmp = tmp[1:]
    p = params[bn_name]
    mu = np.asarray(p["stat_mean"], np.float64)
    sd = np.asarray(p["stat_std"], np.float64)
    if use_relu:
        expect = np.maximum(relu_gaussian_mean(sd, mu), 0.0)
    else:
        expect = mu.copy()

    while tmp:
        idx_bound = 0
        while idx_bound < len(tmp) and len(tmp[idx_bound][0][1]) == depth:
            idx_bound += 1
        if idx_bound == 0:
            depth = len(tmp[0][0][1])
            continue
        for i in range(idx_bound):
            (bn_t, _), use_relu_t, connect_type = tmp[i]
            pt = params[bn_t]
            mu_t = np.asarray(pt["stat_mean"], np.float64)
            sd_t = np.asarray(pt["stat_std"], np.float64)
            if use_relu_t:
                e_t = np.maximum(relu_gaussian_mean(sd_t, mu_t), 0.0)
            else:
                e_t = mu_t
            if connect_type == "cat":
                expect = np.concatenate([expect, e_t], 0)
            else:
                expect = expect + e_t
        tmp = tmp[idx_bound:]
    return expect


def bias_correction(
    graph: Graph,
    params: Dict[str, Dict[str, Any]],
    *,
    bits_weight: int = 8,
    signed: bool = False,
) -> Dict[str, Dict[str, Any]]:
    params = {k: dict(v) for k, v in params.items()}

    # reference builds these incrementally in one topological sweep and uses
    # boolean relu attachment tracking only nn.ReLU (dfq.py:189-211)
    bn_module: Dict[str, object] = {}
    relu_flags: Dict[str, bool] = {}
    bias_prev: Optional[np.ndarray] = None

    for node in graph:
        bots = node.inputs
        if not bots or graph[bots[0]].op == "input":
            continue

        if node.op == "bn" and "stat_std" in params.get(node.name, {}):
            bn_module[node.name] = node
            relu_flags.setdefault(node.name, False)
            if bias_prev is not None:
                p = dict(params[node.name])
                p["stat_mean"] = (
                    np.asarray(p["stat_mean"], np.float32) + bias_prev
                ).astype(np.float32)
                params[node.name] = p
                bias_prev = None
            continue

        if node.op == "relu" and bots[0] in bn_module:
            relu_flags[bots[0]] = True

        if node.op not in _TARGET:
            continue

        attach_str = {k: ("relu" if v else "none") for k, v in relu_flags.items()}
        bn_list, attach_list, ctype_list, _ = find_prev_bn(
            graph, bn_module, attach_str, bots
        )
        if not bn_list:
            continue

        w = np.asarray(params[node.name]["weight"], np.float32)
        eps = _weight_quant_error(w, bits_weight, signed)

        bn_branch: Dict[str, List] = {}
        for idx, item in enumerate(bn_list):
            bn_branch.setdefault(item[1][0], []).append(
                (item, attach_list[idx] == "relu", ctype_list[idx])
            )
        assert len(bn_branch) == 1, (
            "bias correction expects a single merged branch (reference dfq.py:276)"
        )
        expect = _branch_expectation(params, next(iter(bn_branch.values())), relu_flags)

        num_group = expect.shape[0] // eps.shape[1]
        go = eps.shape[0] // num_group
        gi = expect.shape[0] // num_group
        bias_fix = np.zeros(eps.shape[0], np.float64)
        for g in range(num_group):
            bias_fix[g * go : (g + 1) * go] = eps[g * go : (g + 1) * go] @ expect[
                g * gi : (g + 1) * gi
            ]
        bias_fix = bias_fix.astype(np.float32)

        p = dict(params[node.name])
        b = p.get("bias")
        b = np.zeros(w.shape[0], np.float32) if b is None else np.asarray(b, np.float32)
        p["bias"] = (b - bias_fix).astype(np.float32)
        params[node.name] = p
        bias_prev = -bias_fix

    return params
