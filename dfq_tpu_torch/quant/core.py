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

import dataclasses

import numpy as np
import torch

from dfq_tpu_torch.ops.rounding import f32, fma_f32, recip_xla


def _is_torch(*xs) -> bool:
    return any(isinstance(x, torch.Tensor) for x in xs)


@dataclasses.dataclass(frozen=True)
class QSpec:
    """Static quantization spec for one tensor site."""

    bits: int = 8
    symmetric: bool = False
    per_channel: bool = False  # weights only; axis 0 = output channels

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1)) if self.symmetric else 0

    @property
    def qmax(self) -> int:
        return (2 ** (self.bits - 1)) - 1 if self.symmetric else (2**self.bits) - 1


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
    """Quantize-dequantize an f32 tensor with a per-tensor range, in the
    form XLA compiles the JAX package's ``fake_quant`` into under ``jit``
    (pinned by ``tests/test_torch_rounding_forms.py``):

    - a range of Python or numpy numbers is a constant of the program:
      ``scale`` and ``offset`` come from :func:`quant_params` and are
      rounded once to f32 (weak typing), and ``/ scale`` is a multiply by
      ``f32(1 / f32(scale))``;
    - a range of tensors (a per-sample min/max, computed from the data) is
      computed on the device in f32, as JAX computes it from traced
      arrays: ``scale = max(span * f32(1 / qmax), 1e-8)`` and a true
      division;
    - in both, the dequant ``q * scale + offset`` is one FMA.
    """
    if _is_torch(min_value, max_value):
        mn = torch.as_tensor(min_value, dtype=torch.float32, device=x.device)
        mx = torch.as_tensor(max_value, dtype=torch.float32, device=x.device)
        if symmetric:
            qmin, qmax = -(2.0 ** (bits - 1)), 2.0 ** (bits - 1) - 1.0
            span, offset = torch.maximum(mx.abs(), mn.abs()), torch.zeros_like(mn)
        else:
            qmin, qmax = 0.0, 2.0**bits - 1.0
            span, offset = mx - mn, mn
        scale = (span * recip_xla(qmax)).clamp_min(1e-8)
        q = torch.round(torch.clamp((x - offset) / scale, qmin, qmax))
    else:
        scale, offset, qmin, qmax = quant_params(min_value, max_value, bits, symmetric)
        scale, offset = f32(scale), f32(offset)
        q = torch.round(torch.clamp((x - offset) * recip_xla(scale), qmin, qmax))
    return fma_f32(q, scale, offset)


def fake_quant_np(x, min_value, max_value, bits: int = 8, symmetric: bool = False):
    """Host (numpy float32) variant of :func:`fake_quant` for graph passes."""
    x = np.asarray(x, dtype=np.float32)
    scale, offset, qmin, qmax = quant_params(
        np.float32(min_value), np.float32(max_value), bits, symmetric
    )
    q = np.round(np.clip((x - offset) / np.float32(scale), qmin, qmax))
    return (q * np.float32(scale) + offset).astype(np.float32)


def _per_channel_minmax(x):
    """Per-output-channel (axis 0) min and max, numpy or torch."""
    flat = x.reshape(x.shape[0], -1)
    if _is_torch(x):
        return flat.amin(dim=-1), flat.amax(dim=-1)
    return flat.min(axis=-1), flat.max(axis=-1)


def fake_quant_per_channel(x, bits: int = 8, symmetric: bool = False):
    """Per-output-channel (axis 0) quantize-dequantize, numpy or torch."""
    mn, mx = _per_channel_minmax(x)
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


def affine_qparams_from_range(min_value: float, max_value: float, bits: int = 8):
    """(scale, zero_point) for int8 storage of an asymmetric range: the
    zero point is the integer real 0 maps nearest to, in the unsigned
    convention ``[0, 2^b - 1]`` (the engines shift it to int8 by -128)."""
    scale, offset, qmin, qmax = quant_params(
        np.float32(min_value), np.float32(max_value), bits, symmetric=False
    )
    zero_point = int(np.round(-offset / scale))
    zero_point = int(np.clip(zero_point, qmin, qmax))
    return float(scale), zero_point


def symmetric_scale_from_range(min_value, max_value, bits: int = 8):
    """Per-tensor or per-channel symmetric scale, ``max(|min|, |max|) /
    (2^(b-1) - 1)`` (the reciprocal of ncnn's ``128 / max(|min|,|max|)``
    with qmax near 128)."""
    scale, _, _, _ = quant_params(min_value, max_value, bits, symmetric=True)
    return scale
