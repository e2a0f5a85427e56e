"""Data-free activation-range setting from BatchNorm statistics.

Behavioral contract: reference ``set_quant_minmax``
(``utils/layer_transform.py:347-609``). For every
quantizer site, derive (min, max) purely from folded-BN statistics:

a. 1-to-1: range = ``stat_mean ± N * stat_std`` (N=6), min clipped to 0
   after ReLU, max capped at 6 after ReLU6 (``:478-479``).
b. 1-to-many (single site fed by an add/cat subtree): branch statistics
   merged; elementwise adds treat branches as independent Gaussians
   (means/variances accumulate, with closed-form rectified /
   ReLU6-truncated moments applied where activations sit), concats take
   min/max over branches (``:495-568``).
c. many-to-many: per top-level branch results distributed to the node's
   sites in order (``:589-607``).
d. conv/linear without preceding BN (SSD heads): BN stats propagated
   through the layer's own weights via spatially-summed kernels
   (``:459-475``).

The network input site gets the preprocessing range: classification /
segmentation ``[-2.11790393, 2.64]``, detection ``[-1, 1]``
(``:443-449``).

Returns a ``{site: (min, max)}`` dict — no stateful QuantMeasure
modules; the executor consumes this directly.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from dfq_tpu_torch.graph.ir import Graph, node_sites
from dfq_tpu_torch.passes.bn_walk import collect_bn_and_relu, find_prev_bn
from dfq_tpu_torch.quant.moments import (
    relu6_gaussian_mean,
    relu6_gaussian_var,
    relu_gaussian_mean,
    relu_gaussian_var,
)

_EPS = 1e-6

CLS_INPUT_RANGE = (-2.11790393, 2.64)
DET_INPUT_RANGE = (-1.0, 1.0)


def _stats(params, bn_name: str) -> Tuple[np.ndarray, np.ndarray]:
    p = params[bn_name]
    return (
        np.asarray(p["stat_mean"], np.float64),
        np.asarray(p["stat_std"], np.float64),
    )


def _vmin(mu, sd, N, attach: str) -> float:
    v = float(np.min(mu - N * sd))
    return max(0.0, v) if "relu" in attach else v


def _vmax(mu, sd, N, attach: str) -> float:
    v = float(np.max(mu + N * sd))
    return min(6.0, v) if "relu6" in attach else v


def _propagate_no_bn(graph, params, layer_name: str, mu, sd):
    """Case d: push BN stats through a BN-less conv/linear using
    spatially-summed kernels (reference ``:459-475``)."""
    node = graph[layer_name]
    p = params[layer_name]
    w = np.asarray(p["weight"], np.float64)
    b = np.asarray(
        p.get("bias", np.zeros(w.shape[0], np.float32)), np.float64
    )
    if node.op == "conv":
        wsum = w.reshape(w.shape[0], w.shape[1], -1).sum(-1)  # [O, I/g]
        groups = node.attrs.get("groups", 1)
        go = w.shape[0] // groups
        gi = w.shape[1]
        mu_out = np.empty(w.shape[0])
        sd_out = np.empty(w.shape[0])
        for g in range(groups):
            sl_o = slice(g * go, (g + 1) * go)
            sl_i = slice(g * gi, (g + 1) * gi)
            mu_out[sl_o] = wsum[sl_o] @ mu[sl_i] + b[sl_o]
            sd_out[sl_o] = wsum[sl_o] @ sd[sl_i] + b[sl_o]
        return mu_out, sd_out
    return w @ mu + b, w @ sd + b


def _branch_reduce(params, entries, N: float):
    """Merge one top-level branch's BN hits into a range or a Gaussian.

    ``entries``: list of ``((bn_name, bid), attach, ctype)``. Returns
    ``("add...", mean_vec, var_vec)`` or ``(ctype, vmin, vmax)``.
    Mirrors reference ``:495-568`` including its literal quirks (the
    unconditional min-clip in the 'one' accumulation path, ``:558``).
    """
    tmp = sorted(entries, key=lambda e: len(e[0][1]), reverse=True)
    (bn_name, bid), use_relu, connect_type = tmp[0]
    depth = len(bid)
    tmp = tmp[1:]
    mu, sd = _stats(params, bn_name)

    mean = var = None
    vmin = vmax = None
    if "add" in connect_type:
        if use_relu == "relu":
            mean = relu_gaussian_mean(sd, mu)
            var = relu_gaussian_var(sd, mu, mean)
        elif use_relu == "relu6":
            mean = relu6_gaussian_mean(sd, mu)
            var = relu6_gaussian_var(sd, mu, mean)
        else:
            mean = mu.copy()
            var = sd * sd
    else:
        vmin = _vmin(mu, sd, N, use_relu)
        vmax = _vmax(mu, sd, N, use_relu)

    while tmp:
        idx_bound = 0
        while idx_bound < len(tmp) and len(tmp[idx_bound][0][1]) == depth:
            idx_bound += 1
        if idx_bound == 0:
            depth = len(tmp[0][0][1])
            continue
        for i in range(idx_bound):
            (bn_t, _), attach_t, connect_type = tmp[i]
            mu_t, sd_t = _stats(params, bn_t)
            if "add" in connect_type:
                if attach_t == "relu":
                    mt = relu_gaussian_mean(sd_t, mu_t)
                    mean = mean + mt
                    var = var + relu_gaussian_var(sd_t, mu_t, mt)
                elif attach_t == "relu6":
                    mt = relu6_gaussian_mean(sd_t, mu_t)
                    mean = mean + mt
                    var = var + relu6_gaussian_var(sd_t, mu_t, mt)
                else:
                    mean = mean + mu_t
                    var = var + sd_t * sd_t
                # ReLU/ReLU6 sitting directly on the add output
                if "relu6" in connect_type:
                    pre = mean
                    mean = relu6_gaussian_mean(np.sqrt(var + _EPS), pre)
                    var = relu6_gaussian_var(np.sqrt(var + _EPS), pre, mean)
                elif "relu" in connect_type:
                    pre = mean
                    mean = relu_gaussian_mean(np.sqrt(var + _EPS), pre)
                    var = relu_gaussian_var(np.sqrt(var + _EPS), pre, mean)
            else:
                if connect_type == "cat":
                    vmin = min(vmin, _vmin(mu_t, sd_t, N, attach_t))
                    vmax = max(vmax, _vmax(mu_t, sd_t, N, attach_t))
                else:
                    # reference :558-559 — always the ReLU-clipped min here
                    vmin += max(0.0, float(np.min(mu_t - N * sd_t)))
                    vmax += float(np.max(mu_t + N * sd_t))
        tmp = tmp[idx_bound:]
        if connect_type == "one":
            vmin /= idx_bound + 1
            vmax /= idx_bound + 1

    if "add" in connect_type:
        return (connect_type, mean, var)
    return (connect_type, vmin, vmax)


def _gauss_range(mean, var, N: float) -> Tuple[float, float]:
    sd = np.sqrt(var + _EPS)
    return float(np.min(mean - N * sd)), float(np.max(mean + N * sd))


def set_quant_ranges(
    graph: Graph,
    params: Dict[str, Dict[str, Any]],
    *,
    is_detection: bool = False,
    N: float = 6.0,
) -> Dict[str, Tuple[float, float]]:
    bn_module, relu_attached = collect_bn_and_relu(graph, params)
    ranges: Dict[str, Tuple[float, float]] = {}

    for node in graph:
        sites = node_sites(node)
        if not sites:
            continue
        bots = node.inputs[: len(sites)]

        if len(bots) == 1 and graph[bots[0]].op == "input":
            ranges[sites[0]] = DET_INPUT_RANGE if is_detection else CLS_INPUT_RANGE
            continue

        bn_list, attach_list, ctype_list, targ_without_bn = find_prev_bn(
            graph, bn_module, relu_attached, bots
        )
        if not bn_list:
            continue

        if len(sites) == len(bn_list):  # case a (and d): 1-to-1
            for idx, (bn_name, bid) in enumerate(bn_list):
                mu, sd = _stats(params, bn_name)
                if bid[0] in targ_without_bn:
                    _, layer_name = targ_without_bn[bid[0]]
                    mu_p, sd_p = _propagate_no_bn(graph, params, layer_name, mu, sd)
                    vmin = float(np.min(mu_p - N * sd_p))
                    vmax = float(np.max(mu_p + N * sd_p))
                else:
                    vmin = _vmin(mu, sd, N, attach_list[idx])
                    vmax = _vmax(mu, sd, N, attach_list[idx])
                ranges[sites[idx]] = (vmin, vmax)
            continue

        # group by top-level branch (cases b/c)
        bn_branch: Dict[str, List] = {}
        for idx, item in enumerate(bn_list):
            bn_branch.setdefault(item[1][0], []).append(
                (item, attach_list[idx], ctype_list[idx])
            )
        bn_res = {key: _branch_reduce(params, v, N) for key, v in bn_branch.items()}

        if len(sites) == 1 and len(sites) < len(bn_list):  # case b
            assert len(bn_res) == 1, "1-to-many site with multiple branches"
            res = next(iter(bn_res.values()))
            if "add" in res[0]:
                vmin, vmax = _gauss_range(res[1], res[2], N)
            else:
                _, vmin, vmax = res
            ranges[sites[0]] = (vmin, vmax)
        elif len(sites) < len(bn_list):  # case c
            assert len(bn_res) == len(sites), (
                f"branch/site mismatch {len(bn_res)} vs {len(sites)}"
            )
            for idx in range(len(bn_res)):
                res = bn_res[str(idx)]
                if "add" in res[0]:
                    vmin, vmax = _gauss_range(res[1], res[2], N)
                else:
                    _, vmin, vmax = res
                ranges[sites[idx]] = (vmin, vmax)
        else:
            raise AssertionError("more quantizer sites than BN sources")

    return ranges
