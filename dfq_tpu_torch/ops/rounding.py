"""The float32 forms the port mirrors, one helper each.

The JAX reference is compiled by XLA, which does not evaluate the
engine's and the Pallas kernels' epilogues the way they read. Measured
on XLA:CPU (jax 0.9) and pinned by ``tests/test_torch_rounding_forms.py``:

- ``x / c`` with ``c`` a Python float baked into the jitted program is
  rewritten as ``x * f32(1 / f32(c))`` (:func:`recip_xla`). The Pallas
  pointwise and depthwise kernels instead multiply by ``1.0 / s_out``
  computed by Python in float64 and rounded once to f32
  (:func:`recip_host`) — a different reciprocal.
- ``a * b + c`` in one fused loop is contracted into one FMA: one
  rounding of the exact value (:func:`fma_f32`). That holds for the
  ``f32(acc) * scale + bias`` epilogues, the grid-to-grid requant
  ``(q - zp) * ratio + (zp' + 128)`` and the residual's ``q * s - zp * s``.
- A chain of constant multiplies is folded into one constant, computed in
  f32: a spatial mean followed by a quantize multiplies the f32 sum by
  ``f32(f32(1/f32(n)) * f32(1/f32(s)))`` (:func:`mean_quant_recip`).
- Host ratios and products (``s_x / s_c1``, ``zp * s``,
  ``in_scale * w_scale``) are computed by Python/numpy and rounded once to
  f32 (:func:`f32`), as JAX's weak typing does.

Everything rounds half to even (``torch.round``; ``rintf`` in CUDA).
"""

from __future__ import annotations

import numpy as np
import torch


def f32(v) -> float:
    """A Python/numpy number rounded once to float32 (JAX weak typing)."""
    return float(np.float32(v))


def recip_host(s: float) -> float:
    """``f32(1.0 / s)``: Python's float64 reciprocal rounded once — the
    constant the Pallas K1/K2 kernels multiply by."""
    return f32(1.0 / s)


def recip_xla(s: float) -> float:
    """``f32(1) / f32(s)`` in f32 — what XLA multiplies by for ``x / s``."""
    return float(np.float32(1) / np.float32(s))


def mean_quant_recip(n: int, s: float) -> float:
    """The folded constant of ``round(mean_n(x) / s)``."""
    return float(np.float32(np.float32(1) / np.float32(n)) * np.float32(recip_xla(s)))


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (XLA:CPU's contracted FMA).

    ``a`` is an f32 tensor whose values, like ``b`` and ``c`` (f32
    tensors or f32-exact floats), are widened to float64: the product of
    two f32 values is exact there, and the sum is rounded once more to
    f32 (equal to a true FMA except when that sum is itself inexact in
    float64 and lands on an f32 midpoint)."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


def quant_u8(f: torch.Tensor, r: float, zp: int, lo: float = 0.0,
             hi: float = 255.0) -> torch.Tensor:
    """``(clip(round(f * r) + (zp + 128), lo, hi) - 128)`` as int8: the
    engine's ``_quantize_f32`` and K3's quantizers, with ``r`` from
    :func:`recip_xla` and ``lo``/``hi`` on the uint8 grid."""
    q = torch.round(f * r) + (zp + 128)
    return (torch.clamp(q, lo, hi) - 128.0).to(torch.int8)


def requant_i8(q: torch.Tensor, zp_from: int, ratio: float, zp_to: int) -> torch.Tensor:
    """Grid-to-grid int8 requant ``clip(round((q - zp) * ratio + (zp' +
    128)), 0, 255) - 128`` with the multiply-add as one FMA; ``ratio`` is
    ``f32(s_from / s_to)``."""
    r = fma_f32(q.to(torch.float32) - zp_from, ratio, float(zp_to + 128))
    return (torch.clamp(torch.round(r), 0.0, 255.0) - 128.0).to(torch.int8)
