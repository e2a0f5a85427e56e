"""Activation ranges from data (port of ``dfq_tpu/calib/calibrate.py``).

Behavioral contract: the reference's ``update_quant_range``
(``improve_dfq.py:280-297``) with ``QuantMeasure.forward`` in the state
the reference reaches it, where each site runs both its ``update_stat``
branch and its training branch:

1. stat = batch mean of the per-sample min/max of the site's input,
2. ``running <- extreme(running, stat)`` (the update_stat merge),
3. ``running <- running*(1-m) + stat*m``, m = 0.1 (the training EMA),
4. the site quantizes with the batch stat itself (``self_quant``), so the
   forwards do not depend on the running ranges.

Running ranges start at 0; the input site is finally pinned to the
preprocessing range. :func:`estimate_stats` is the reference's
``estimate_stats`` (``main_seg.py:40-82``): the EMA alone, over epochs.

Each forward is the simulator (``capture="minmax", self_quant=True``)
under ``torch.no_grad()`` on one device; the recurrence runs on host
floats.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from dfq_tpu_torch.device import resolve_device
from dfq_tpu_torch.graph.executor import execute, params_to
from dfq_tpu_torch.graph.ir import Graph, quant_sites
from dfq_tpu_torch.passes.range_setter import CLS_INPUT_RANGE, DET_INPUT_RANGE


def _observer(graph: Graph, params, bits_act: int, device):
    """``batch -> {site: (mean of per-sample min, of max)}`` as host floats."""
    dev = resolve_device(device)
    p = params_to(params, dev)

    def observe(batch) -> Dict[str, Tuple[float, float]]:
        x = torch.as_tensor(np.asarray(batch, np.float32)).to(dev)
        with torch.no_grad():
            _, aux = execute(graph, p, x, bits_act=bits_act, capture="minmax",
                             self_quant=True, device=dev)
        stats = torch.stack([torch.stack(aux[s]) for s in aux]).cpu().tolist()
        return {s: (mn, mx) for s, (mn, mx) in zip(aux, stats)}

    return observe


def calibrate_ranges(graph: Graph, params, batches: Iterable[np.ndarray], *,
                     bits_act: int = 8, is_detection: bool = False,
                     device=None) -> Dict[str, Tuple[float, float]]:
    sites = quant_sites(graph)
    ranges: Dict[str, Tuple[float, float]] = {s: (0.0, 0.0) for s in sites}
    momentum = 0.1  # QuantMeasure's default
    observe = _observer(graph, params, bits_act, device)
    for batch in batches:
        stat = observe(batch)
        for s in sites:
            mn, mx = stat[s]
            lo, hi = ranges[s]
            lo, hi = min(lo, mn), max(hi, mx)  # update_stat merge, then the EMA
            ranges[s] = (lo * (1.0 - momentum) + mn * momentum,
                         hi * (1.0 - momentum) + mx * momentum)

    # pin the network-input site (improve_dfq.py:288-296)
    for node in graph:
        if node.op in ("conv", "linear") and node.inputs:
            if graph[node.inputs[0]].op == "input":
                ranges[f"{node.name}:in0"] = DET_INPUT_RANGE if is_detection else CLS_INPUT_RANGE
    return ranges


def estimate_stats(graph: Graph, params, batches: Iterable[np.ndarray], *,
                   momentum: float = 0.1, num_epoch: int = 10, bits_act: int = 8,
                   device=None) -> Dict[str, Tuple[float, float]]:
    """Data-dependent range estimation over real images: the EMA
    ``running <- running*(1-m) + batch_stat*m`` per site over
    ``num_epoch`` passes of ``batches`` (a list or any re-iterable).
    Returns the frozen ranges to evaluate with."""
    sites = quant_sites(graph)
    ranges: Dict[str, Tuple[float, float]] = {s: (0.0, 0.0) for s in sites}
    observe = _observer(graph, params, bits_act, device)
    for _ in range(num_epoch):
        for batch in batches:
            stat = observe(batch)
            for s in sites:
                mn, mx = stat[s]
                lo, hi = ranges[s]
                ranges[s] = (lo * (1.0 - momentum) + mn * momentum,
                             hi * (1.0 - momentum) + mx * momentum)
    return ranges
