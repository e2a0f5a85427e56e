"""int8 lowering (port of ``dfq_tpu/engine/int8.py``: the parts the fused
engine needs).

- conv/linear weights stored as int8 with per-output-channel symmetric
  scales,
- activations quantized per-tensor asymmetric (zero point) from the
  data-free ranges,
- the zero-point cross term folded through precomputed weight sums:
  ``conv(x, w) = s_in*s_w * (conv(q, qw) - zp * colsum(qw))``.

``lower_int8`` consumes a :class:`~dfq_tpu_torch.pipeline.PreparedModel`
(its post-pass, pre-weight-quant ``params_fp``) and is host numpy, equal
to the JAX package's field for field. The baseline engine
``execute_int8`` is not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dfq_tpu_torch.graph.ir import Graph
from dfq_tpu_torch.ops.rounding import quant_u8, recip_xla
from dfq_tpu_torch.pipeline import PreparedModel
from dfq_tpu_torch.quant.core import fake_quant_np


@dataclasses.dataclass
class Int8Layer:
    qweight: np.ndarray  # int8, OIHW (conv) or [out, in] (linear)
    w_scale: np.ndarray  # f32 [O] per-output-channel symmetric scale
    # f32 [O]; snapped to the bias-bit grid when cfg.bits_bias < 32
    bias: Optional[np.ndarray]
    wsum: np.ndarray  # int32 [O] sum of qweight over (in, spatial)
    in_scale: float
    in_zp: int  # int8-domain zero point (range [-128, 127])


@dataclasses.dataclass
class Int8Model:
    graph: Graph
    layers: Dict[str, Int8Layer]
    act_ranges: Dict[str, Tuple[float, float]]
    bits_act: int = 8


def _quantize_weight_per_channel(w: np.ndarray, bits: int = 8):
    qmax = 2.0 ** (bits - 1) - 1.0
    flat = np.abs(w.reshape(w.shape[0], -1))
    amax = flat.max(axis=1)
    scale = np.maximum(amax / qmax, 1e-12).astype(np.float32)
    shape = (-1,) + (1,) * (w.ndim - 1)
    q = np.clip(np.round(w / scale.reshape(shape)), -qmax - 1, qmax)
    return q.astype(np.int8), scale


def lower_int8(prepared: PreparedModel, bits_act: Optional[int] = None) -> Int8Model:
    graph = prepared.graph
    params = prepared.params_fp or prepared.params
    bits_w = prepared.cfg.bits_weight
    if bits_w > 8:
        raise ValueError(
            f"true-int8 engine supports bits_weight <= 8, got {bits_w}; "
            "use the fake-quant simulator for wider regimes"
        )
    if bits_act is None:
        bits_act = prepared.cfg.bits_activation
    if bits_act > 8:
        raise ValueError(
            f"true-int8 engine supports bits_activation <= 8, got {bits_act}"
        )
    layers: Dict[str, Int8Layer] = {}
    for node in graph:
        if node.op not in ("conv", "linear"):
            continue
        site = f"{node.name}:in0"
        if site not in prepared.act_ranges:
            continue  # unquantized layer stays f32
        lo, hi = prepared.act_ranges[site]
        qmax_a = 2.0**bits_act - 1.0
        in_scale = max((hi - lo) / qmax_a, 1e-8)
        # uint-domain zp snapped to the grid, shifted to int8 domain
        zp_u = int(np.clip(np.round(-lo / in_scale), 0, qmax_a))
        in_zp = zp_u - 128

        p = params[node.name]
        w = np.asarray(p["weight"], np.float32)
        qw, w_scale = _quantize_weight_per_channel(w, bits=bits_w)
        wsum = qw.astype(np.int32).reshape(qw.shape[0], -1).sum(axis=1).astype(np.int32)
        bias = p.get("bias")
        if bias is not None:
            bias = np.asarray(bias, np.float32)
            # bias-bit grid: Int8** = 16-bit bias, Int8* = 8-bit, Int8' =
            # raw 32-bit; the same per-tensor min/max snap as the weights
            bits_bias = prepared.cfg.bits_bias
            if bits_bias < 32 and bias.size:
                bias = fake_quant_np(
                    bias, float(bias.min()), float(bias.max()),
                    bits=bits_bias, symmetric=prepared.cfg.signed,
                )
        layers[node.name] = Int8Layer(
            qweight=qw,
            w_scale=w_scale,
            bias=bias,
            wsum=wsum,
            in_scale=float(in_scale),
            in_zp=in_zp,
        )
    return Int8Model(
        graph=graph,
        layers=layers,
        act_ranges=dict(prepared.act_ranges),
        bits_act=bits_act,
    )


def _quantize_act(x: torch.Tensor, layer: Int8Layer, qmax: float = 255.0) -> torch.Tensor:
    """f32 -> int8 with the layer's input qparams. ``x / in_scale`` is, as
    XLA compiles it, ``x * f32(1 / f32(in_scale))``."""
    return quant_u8(x, recip_xla(layer.in_scale), layer.in_zp, 0.0, qmax)


# largest K = Cin/groups * kh * kw for which an f32 conv of int8 operands
# is exact: every partial sum stays below 2^24 (|products| <= 2^14)
_F32_EXACT_K = 1024


def _int8_conv(xq: torch.Tensor, node, qweight: torch.Tensor, zp: int) -> torch.Tensor:
    """int8 NHWC conv with OIHW int8 weights -> int32 NHWC, with zero-point
    padding: real 0 quantizes to ``zp``, so the spatial padding holds
    ``zp`` for the ``acc - zp * colsum(w)`` fold to be exact at the
    borders.

    This is the work the JAX package left to XLA's int8 conv (the stem and
    the stride-2 depthwise convs). On the CPU it runs in float64; on CUDA
    as an f32 conv with TF32 off, which is exact while
    ``Cin/groups * kh * kw <= 1024`` (checked)."""
    a = node.attrs
    ph, pw = a["padding"]
    x = xq.permute(0, 3, 1, 2)
    if (ph, pw) != (0, 0):
        x = F.pad(x, (pw, pw, ph, ph), value=zp)
    if xq.device.type == "cpu":
        dtype = torch.float64
    else:
        k = qweight.shape[1] * qweight.shape[2] * qweight.shape[3]
        if k > _F32_EXACT_K:
            raise ValueError(
                f"{node.name}: f32 conv of K={k} int8 products is not exact "
                f"(limit {_F32_EXACT_K})"
            )
        dtype = torch.float32
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        acc = F.conv2d(
            x.to(dtype), qweight.to(dtype), stride=a["stride"],
            dilation=a["dilation"], groups=a["groups"],
        )
    return acc.to(torch.int32).permute(0, 2, 3, 1).contiguous()
