"""One-shot weight (and bias) fake quantization.

Reference: ``quantize_targ_layer``
(``utils/layer_transform.py:279-296``) — per-tensor
min/max fake-quant of every target layer's weight, and of its bias when
``bits_bias < 32``. The real-int8 engine replaces this with per-channel
int8 storage (``engine/int8.py:lower_int8``); this pass exists for the
fake-quant simulation regimes (Int8**, Int8*, Int8').
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from dfq_tpu_torch.graph.ir import Graph
from dfq_tpu_torch.quant.core import fake_quant_np

_TARGET = {"conv", "linear"}


def quantize_layer_weights(
    graph: Graph,
    params: Dict[str, Dict[str, Any]],
    bits_weight: int = 8,
    bits_bias: int = 16,
    *,
    signed: bool = False,
    per_channel: bool = False,
) -> Dict[str, Dict[str, Any]]:
    params = {k: dict(v) for k, v in params.items()}
    for node in graph:
        if node.op not in _TARGET or node.name not in params:
            continue
        p = dict(params[node.name])
        w = np.asarray(p["weight"], np.float32)
        if per_channel:
            from dfq_tpu_torch.quant.core import fake_quant_per_channel

            p["weight"] = fake_quant_per_channel(
                w, bits=bits_weight, symmetric=signed
            ).astype(np.float32)
        else:
            p["weight"] = fake_quant_np(
                w, float(w.min()), float(w.max()), bits=bits_weight, symmetric=signed
            )
        if p.get("bias") is not None and bits_bias < 32:
            b = np.asarray(p["bias"], np.float32)
            p["bias"] = fake_quant_np(
                b, float(b.min()), float(b.max()), bits=bits_bias, symmetric=signed
            )
        params[node.name] = p
    return params
