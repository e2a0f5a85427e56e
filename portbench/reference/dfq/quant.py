"""Host (numpy) fake quantization for the frozen DFQ passes: the numpy
branches of ``dfq_tpu_torch/quant/core.py`` as of this benchmark's first
version."""

from __future__ import annotations

import numpy as np


def quant_params(min_value, max_value, bits: int = 8, symmetric: bool = False):
    """``(scale, offset, qmin, qmax)`` of a range, with the ``max(scale,
    1e-8)`` floor."""
    if symmetric:
        qmin = -(2.0 ** (bits - 1))
        qmax = 2.0 ** (bits - 1) - 1.0
        amax = np.maximum(np.abs(max_value), np.abs(min_value))
        scale = amax / qmax
        offset = np.zeros_like(scale)
    else:
        qmin = 0.0
        qmax = 2.0**bits - 1.0
        scale = (np.asarray(max_value) - min_value) / (qmax - qmin)
        offset = np.asarray(min_value)
    scale = np.maximum(scale, 1e-8)
    return scale, offset, qmin, qmax


def fake_quant_np(x, min_value, max_value, bits: int = 8, symmetric: bool = False):
    """Quantize-dequantize a float32 array with a per-tensor range."""
    x = np.asarray(x, dtype=np.float32)
    scale, offset, qmin, qmax = quant_params(
        np.float32(min_value), np.float32(max_value), bits, symmetric
    )
    q = np.round(np.clip((x - offset) / np.float32(scale), qmin, qmax))
    return (q * np.float32(scale) + offset).astype(np.float32)
