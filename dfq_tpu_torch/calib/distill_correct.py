"""Empirical (distilled-data) bias correction (port of
``dfq_tpu/calib/distill_correct.py``).

Behavioral contract: the reference's ``bias_correction_distill``
(``improve_dfq.py:311-371``): run the quantized model and the FP32 model
over the distilled batches, accumulate each conv/linear layer's batch and
spatial mean output, and subtract the per-channel difference from the
quantized layer's bias.

Deviation, as in the JAX package: the reference sums the error over
spatial positions (``improve_dfq.py:364``), which overcorrects by HxW; that
code path is dead (its call site is commented out, ``main_cls.py:166-177``),
so the spatial MEAN is used here.

The reference's forward hooks are the simulator's
``capture="layer_outputs"`` mode; both models share the graph (folded,
ReLU-swapped) with quantized vs FP32 params.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Tuple

import numpy as np
import torch

from dfq_tpu_torch.device import resolve_device
from dfq_tpu_torch.graph.executor import execute, params_to
from dfq_tpu_torch.graph.ir import Graph


def bias_correction_distill(
    graph: Graph,
    params_q: Dict[str, Dict[str, Any]],
    act_ranges: Dict[str, Tuple[float, float]],
    params_fp: Dict[str, Dict[str, Any]],
    batches: Iterable[np.ndarray],
    bits_act: int = 8,
    device=None,
) -> Dict[str, Dict[str, Any]]:
    """``params_q`` with each conv/linear bias moved by minus its layer's
    mean output error over ``batches`` (host numpy params)."""
    dev = resolve_device(device)
    pq, pf = params_to(params_q, dev), params_to(params_fp, dev)
    acc_q: Dict[str, np.ndarray] = {}
    acc_fp: Dict[str, np.ndarray] = {}
    n = 0
    with torch.no_grad():
        for batch in batches:
            x = torch.as_tensor(np.asarray(batch, np.float32)).to(dev)
            _, aq = execute(graph, pq, x, act_ranges=act_ranges, bits_act=bits_act,
                            capture="layer_outputs", device=dev)
            _, af = execute(graph, pf, x, capture="layer_outputs", device=dev)
            for k in aq:
                acc_q[k] = acc_q.get(k, 0.0) + aq[k].cpu().numpy()
                acc_fp[k] = acc_fp.get(k, 0.0) + af[k].cpu().numpy()
            n += 1

    params_q = {k: dict(v) for k, v in params_q.items()}
    for name in acc_q:
        error = (acc_q[name] - acc_fp[name]) / n
        p = dict(params_q[name])
        b = p.get("bias")
        b = np.zeros(error.shape[0], np.float32) if b is None else np.asarray(b, np.float32)
        p["bias"] = (b - error.astype(np.float32)).astype(np.float32)
        params_q[name] = p
    return params_q
