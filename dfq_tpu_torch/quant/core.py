"""Uniform quantization primitives (port of ``dfq_tpu/quant/core.py``).

Pure functions usable on host numpy (the graph passes, exact float32) and
on torch tensors (the executable paths). Semantics, per tensor, ``bits`` =
b:

- asymmetric (default): ``qmin = 0``, ``qmax = 2**b - 1``,
  ``scale = (max - min) / qmax`` (clamped to >= 1e-8);
  ``qdq(x) = round(clip((x - min)/scale, qmin, qmax)) * scale + min``.
- symmetric signed: ``qmin = -2**(b-1)``, ``qmax = 2**(b-1) - 1``,
  ``scale = max(|max|, |min|) / qmax``; ``qdq(x) = round(clip(x/scale,
  qmin, qmax)) * scale``.

Rounding is round-half-to-even in numpy and torch alike.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_torch(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


def quant_params(min_value, max_value, bits: int = 8, symmetric: bool = False):
    """Return ``(scale, offset, qmin, qmax)`` for the given range.

    ``offset`` is the real-valued minimum used for affine mapping (0 for
    symmetric). Works on scalars, numpy arrays or torch tensors
    (per-channel ranges), with the ``max(scale, 1e-8)`` floor and the
    |max|<|min| swap of symmetric mode.
    """
    if _is_torch(min_value, max_value):
        mn = torch.as_tensor(min_value)
        mx = torch.as_tensor(max_value)
        if symmetric:
            qmin = -(2.0 ** (bits - 1))
            qmax = 2.0 ** (bits - 1) - 1.0
            scale = torch.maximum(mx.abs(), mn.abs()) / qmax
            offset = torch.zeros_like(scale)
        else:
            qmin = 0.0
            qmax = 2.0**bits - 1.0
            scale = (mx - mn) / (qmax - qmin)
            offset = mn
        return scale.clamp_min(1e-8), offset, qmin, qmax
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


def fake_quant(x: torch.Tensor, min_value, max_value, bits: int = 8,
               symmetric: bool = False) -> torch.Tensor:
    """Quantize-dequantize a tensor with a per-tensor range
    (add/div/clamp/round/mul/add order of the reference). Python or numpy
    range bounds give a float64 scale that is rounded once to ``x``'s
    dtype, as the JAX package's weak typing does."""
    scale, offset, qmin, qmax = quant_params(min_value, max_value, bits, symmetric)
    scale = torch.as_tensor(scale, device=x.device).to(x.dtype)
    offset = torch.as_tensor(offset, device=x.device).to(x.dtype)
    q = torch.round(torch.clamp((x - offset) / scale, qmin, qmax))
    return q * scale + offset


def fake_quant_np(x, min_value, max_value, bits: int = 8, symmetric: bool = False):
    """Host (numpy float32) variant of :func:`fake_quant` for graph passes."""
    x = np.asarray(x, dtype=np.float32)
    scale, offset, qmin, qmax = quant_params(
        np.float32(min_value), np.float32(max_value), bits, symmetric
    )
    q = np.round(np.clip((x - offset) / np.float32(scale), qmin, qmax))
    return (q * np.float32(scale) + offset).astype(np.float32)


def fake_quant_per_channel(x, bits: int = 8, symmetric: bool = False):
    """Per-output-channel (axis 0) quantize-dequantize, numpy or torch."""
    flat = x.reshape(x.shape[0], -1)
    if _is_torch(x):
        mn, mx = flat.amin(dim=-1), flat.amax(dim=-1)
    else:
        mn, mx = flat.min(axis=-1), flat.max(axis=-1)
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    scale, offset, qmin, qmax = quant_params(mn, mx, bits, symmetric)
    scale = scale.reshape(shape)
    offset = offset.reshape(shape)
    if _is_torch(x):
        q = torch.round(torch.clamp((x - offset) / scale, qmin, qmax))
    else:
        q = np.round(np.clip((x - offset) / scale, qmin, qmax))
    return q * scale + offset


def quantize_int(x, scale, zero_point, qmin: int, qmax: int, dtype=None):
    """Real quantization to integers: ``clip(round(x/scale) + zp)``;
    ``dtype`` defaults to int8 of the input's library."""
    if _is_torch(x):
        q = torch.clamp(torch.round(x / scale) + zero_point, qmin, qmax)
        return q.to(dtype or torch.int8)
    q = np.clip(np.round(x / scale) + zero_point, qmin, qmax)
    return q.astype(dtype or np.int8)


def dequantize_int(q, scale, zero_point):
    if _is_torch(q):
        return (q.to(torch.float32) - zero_point) * scale
    return (q.astype(np.float32) - zero_point) * scale
