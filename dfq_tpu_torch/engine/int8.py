"""int8 lowering and the baseline int8 engine (port of
``dfq_tpu/engine/int8.py``).

- conv/linear weights stored as int8 with per-output-channel symmetric
  scales,
- activations quantized per-tensor asymmetric (zero point) from the
  data-free ranges,
- the zero-point cross term folded through precomputed weight sums:
  ``conv(x, w) = s_in*s_w * (conv(q, qw) - zp * colsum(qw))``.

``lower_int8`` consumes a :class:`~dfq_tpu_torch.pipeline.PreparedModel`
(its post-pass, pre-weight-quant ``params_fp``) and is host numpy, equal
to the JAX package's field for field.

:class:`Int8Net` is the baseline engine (``execute_int8``): every lowered
conv and linear layer quantizes its f32 input, runs an exact int8
product (:func:`int8_conv`, :func:`int8_linear`) and dequantizes with an
f32 epilogue; every other op runs in f32 with the simulator's site
fake-quant. All ``bits_act <= 8`` regimes run here.

The int8 products are exact by construction, for any K: float64 on the
CPU; on CUDA, dense convs are ``k*k`` accumulated int8 GEMMs over shifted
views of the zero-point-padded input (:func:`int8_conv_shift9`, the JAX
package's ``_int8_conv_shift9``) and linear layers one int8 GEMM, both
``torch._int_mm`` (int8 x int8 -> int32 on the tensor cores; the JAX
package leaves these products to XLA), zero-padded to its shape rule.
Grouped convs, and dense convs whose ``Cin`` is not a multiple of 8 (the
3-channel stems), run as an f32 cuDNN conv with TF32 off, exact while
``K = Cin/groups * kh * kw <= 1024``; beyond that they too go to
``torch._int_mm``, a group at a time.

The fused engine's policies (``engine/int8_fused.py``) lower a conv in
two more exact forms: :func:`int8_conv_im2col` (one GEMM over the
concatenated shifted views) and :func:`int8_conv_b2s` (the batch stacked
along H with zero-point seams, one VALID conv). Each form's weights are
packed for it (:func:`pack_int8_product`'s ``form``); on the CPU the
shifted-view forms take float64 products a tap or a patch, never the f64
``F.conv2d`` of :func:`int8_conv`'s default route.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from torch import nn

from dfq_tpu_torch.device import resolve_device
from dfq_tpu_torch.graph.executor import apply_op, highest_precision, params_to
from dfq_tpu_torch.graph.ir import Graph
from dfq_tpu_torch.ops.rounding import f32, fma_f32, mean_quant_recip, quant_u8, recip_xla
from dfq_tpu_torch.pipeline import PreparedModel
from dfq_tpu_torch.quant.core import fake_quant, fake_quant_np


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
F32_EXACT_K = 1024
# torch._int_mm on CUDA takes M > 16 and K, N multiples of 8
INT_MM_MIN_M = 17
INT_MM_ALIGN = 8


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def int_mm_exact(a: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8 @ w_nk[N, K]^T -> int32 [M, N]`` by ``torch._int_mm``,
    with ``a``'s rows and columns zero-padded to its shape rule (``w_nk``
    comes padded: N and K multiples of 8). Zero rows and columns add
    nothing; the padded rows are sliced off."""
    M, K = a.shape
    Kp = w_nk.shape[1]
    Mp = max(M, INT_MM_MIN_M)
    if (Mp, Kp) != (M, K):
        a = F.pad(a, (0, Kp - K, 0, Mp - M))
    out = torch._int_mm(a.contiguous(), w_nk.t())
    return out[:M] if Mp != M else out


@dataclasses.dataclass
class Int8Product:
    """An int8 conv's or linear layer's weights, packed once on the device
    for its exact route:

    - ``"f64"`` (the CPU): ``w`` float64, OIHW or ``[N, K]``;
    - ``"f32"`` (CUDA, grouped convs and small-channel stems with
      K <= 1024): ``w`` float32 OIHW, cuDNN with TF32 off;
    - ``"int_mm"``: ``w`` ``[groups, kh*kw, Np, Kp]``, one row-major
      ``[N, K]`` matrix a group and tap, N and K zero-padded to multiples
      of 8 (a linear layer: one group, one tap); int8 for
      ``torch._int_mm`` (CUDA), or float64 (the CPU's shift9 and b2s
      forms);
    - ``"im2col"``: ``w`` ``[1, 1, Np, Kp]``, the ``[N, kh*kw*Cin]``
      matrix in (ky, kx, cin) order, padded as ``"int_mm"``; int8 on CUDA,
      float64 on the CPU.
    """

    route: str
    w: torch.Tensor
    n_out: int  # output channels (before padding)


# the lowerings a conv's product can be packed for (pack_int8_product)
FORMS = ("conv", "b2s", "shift9", "im2col")


def pack_int8_product(qweight: np.ndarray, node, device, form: str = "conv") -> Int8Product:
    """Pack an int8 OIHW conv weight (or ``[N, K]`` linear weight) on
    ``device`` for the conv's lowering ``form``:

    - ``"conv"``: :func:`int8_conv`'s route (``"f64"`` on the CPU;
      ``"f32"`` or ``"int_mm"`` on CUDA, by the rule of the module
      docstring);
    - ``"b2s"``: :func:`int8_conv_b2s`, the same route on CUDA, per-tap
      float64 products (``"int_mm"``) on the CPU;
    - ``"shift9"``: :func:`int8_conv_shift9` (``"int_mm"``);
    - ``"im2col"``: :func:`int8_conv_im2col` (``"im2col"``)."""
    if form not in FORMS:
        raise ValueError(f"unknown conv form {form!r}; expected one of {FORMS}")
    dev = resolve_device(device)
    exact = torch.float64 if dev.type == "cpu" else torch.int8
    if form == "im2col":
        return pack_im2col(qweight, dev, exact)
    if form == "shift9" or (form == "b2s" and dev.type == "cpu"):
        return pack_int_mm(qweight, node, dev, exact)
    qw = torch.as_tensor(np.asarray(qweight))
    if dev.type == "cpu":
        return Int8Product("f64", qw.to(torch.float64).contiguous(), qw.shape[0])
    if node.op == "conv":
        _, cin_g, kh, kw = qw.shape
        if cin_g * kh * kw <= F32_EXACT_K and (
                node.attrs["groups"] > 1 or cin_g % INT_MM_ALIGN):
            return Int8Product("f32", qw.to(device=dev, dtype=torch.float32).contiguous(),
                               qw.shape[0])
    return pack_int_mm(qweight, node, dev)


def _pad_nk(w: torch.Tensor) -> torch.Tensor:
    """Zero-pad the last two dims (N, K) to multiples of 8."""
    n, k = w.shape[-2:]
    return F.pad(w, (0, _round_up(k, INT_MM_ALIGN) - k, 0, _round_up(n, INT_MM_ALIGN) - n))


def pack_int_mm(qweight: np.ndarray, node, device, dtype=torch.int8) -> Int8Product:
    """The ``"int_mm"`` packing, on any device (``torch._int_mm`` runs on
    the CPU too, which the tests use to check the padding); ``dtype``
    float64 holds the same layout for the CPU's per-tap products."""
    qw = torch.as_tensor(np.asarray(qweight))
    n_out = qw.shape[0]
    if node.op == "linear":
        taps = qw.reshape(1, 1, n_out, -1)
    else:
        O, cin_g, kh, kw = qw.shape
        groups = node.attrs["groups"]
        # [O, cin_g, kh, kw] -> [groups, kh*kw, O/groups, cin_g]
        taps = qw.reshape(groups, O // groups, cin_g, kh * kw).permute(0, 3, 1, 2)
    return Int8Product("int_mm", _pad_nk(taps).to(device=device, dtype=dtype).contiguous(),
                       n_out)


def pack_im2col(qweight: np.ndarray, device, dtype=torch.int8) -> Int8Product:
    """The ``"im2col"`` packing of a dense OIHW conv weight: ``[N,
    kh*kw*Cin]`` in (ky, kx, cin) order, the order in which
    :func:`int8_conv_im2col` concatenates its views."""
    qw = torch.as_tensor(np.asarray(qweight))
    w = qw.permute(0, 2, 3, 1).reshape(1, 1, qw.shape[0], -1)
    return Int8Product("im2col", _pad_nk(w).to(device=device, dtype=dtype).contiguous(),
                       qw.shape[0])


def shifted_views(xp: torch.Tensor, node):
    """The ``kh*kw`` stride/dilation-aware shifted views of a padded NHWC
    input, in (ky, kx) row-major tap order, and the output size."""
    a = node.attrs
    (kh, kw), (sh, sw), (dh, dw) = a["kernel"], a["stride"], a["dilation"]
    _, hp, wp, _ = xp.shape
    oh = (hp - dh * (kh - 1) - 1) // sh + 1
    ow = (wp - dw * (kw - 1) - 1) // sw + 1
    views = [xp[:, ky * dh: ky * dh + (oh - 1) * sh + 1: sh,
                kx * dw: kx * dw + (ow - 1) * sw + 1: sw]
             for ky in range(kh) for kx in range(kw)]
    return views, oh, ow


def _mm_exact(a: torch.Tensor, w_nk: torch.Tensor) -> torch.Tensor:
    """``a [M, K] int8`` times a packed ``[Np, Kp]`` matrix -> int32
    ``[M, Np]``: ``torch._int_mm`` for an int8 matrix, float64 for a
    float64 one (every sum below 2^53)."""
    if w_nk.dtype == torch.int8:
        return int_mm_exact(a, w_nk)
    return (a.to(torch.float64) @ w_nk[:, :a.shape[1]].t()).to(torch.int32)


def _tap_products(views, prod: Int8Product) -> torch.Tensor:
    """``sum_t view_t @ W_t`` over the taps, a group at a time -> int32
    ``[M, n_out]``."""
    groups = prod.w.shape[0]
    cin_g = views[0].shape[-1] // groups
    opg = prod.n_out // groups
    if prod.w.dtype == torch.float64:
        # every group at once; float64 sums are exact
        acc = None
        for t, v in enumerate(views):
            d = torch.einsum("mgk,gnk->mgn", v.reshape(-1, groups, cin_g).to(torch.float64),
                             prod.w[:, t, :, :cin_g])
            acc = d if acc is None else acc.add_(d)
        return acc[:, :, :opg].reshape(acc.shape[0], -1).to(torch.int32)
    outs = []
    for g in range(groups):
        acc = None
        for t, v in enumerate(views):
            a2 = v[..., g * cin_g:(g + 1) * cin_g].reshape(-1, cin_g)
            d = _mm_exact(a2, prod.w[g, t])
            acc = d if acc is None else acc.add_(d)
        outs.append(acc[:, :opg])
    return outs[0] if groups == 1 else torch.cat(outs, dim=-1)


def _conv_valid(xp: torch.Tensor, node, prod: Int8Product, raw: bool = False) -> torch.Tensor:
    """The unpadded (VALID) int8 NHWC conv of ``xp`` -> int32 NHWC by
    ``prod``'s route; ``node``'s padding is not read. ``raw`` leaves a
    float route's output as ``F.conv2d`` gives it (NCHW by its shape,
    exact integers), for an epilogue that reads it in place."""
    a = node.attrs
    B = xp.shape[0]
    if prod.route in ("f64", "f32"):
        dtype = torch.float64 if prod.route == "f64" else torch.float32
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            acc = F.conv2d(xp.permute(0, 3, 1, 2).to(dtype), prod.w, stride=a["stride"],
                           dilation=a["dilation"], groups=a["groups"])
        return acc if raw else acc.to(torch.int32).permute(0, 2, 3, 1).contiguous()
    views, oh, ow = shifted_views(xp, node)
    if prod.route == "im2col":
        patches = torch.cat(views, dim=-1)
        acc = _mm_exact(patches.reshape(-1, patches.shape[-1]), prod.w[0, 0])[:, :prod.n_out]
    else:
        acc = _tap_products(views, prod)
    return acc.reshape(B, oh, ow, prod.n_out)


def _zp_pad(xq: torch.Tensor, node, zp: int) -> torch.Tensor:
    ph, pw = node.attrs["padding"]
    return F.pad(xq, (0, 0, pw, pw, ph, ph), value=zp) if (ph, pw) != (0, 0) else xq


def int8_conv(xq: torch.Tensor, node, prod: Int8Product, zp: int,
              raw: bool = False) -> torch.Tensor:
    """int8 NHWC conv -> int32 NHWC, with zero-point padding: real 0
    quantizes to ``zp``, so the spatial padding holds ``zp`` for the
    ``acc - zp * colsum(w)`` fold to be exact at the borders. ``raw``: as
    :func:`_conv_valid`'s."""
    return _conv_valid(_zp_pad(xq, node, zp), node, prod, raw)


def int8_conv_shift9(xq: torch.Tensor, node, prod: Int8Product, zp: int) -> torch.Tensor:
    """Dense ``k*k`` int8 conv as ``k^2`` accumulated GEMMs over shifted
    views of the zero-point-padded input (``prod`` packed for
    ``"shift9"``): ``[B*oh*ow, Cin] x [Cin, Cout]`` a tap, ``torch._int_mm``
    on CUDA, float64 on the CPU. Exact; any stride and dilation."""
    if prod.route != "int_mm" or node.attrs["groups"] != 1:
        raise ValueError("int8_conv_shift9 takes a dense conv packed for 'shift9'")
    return int8_conv(xq, node, prod, zp)


def int8_conv_im2col(xq: torch.Tensor, node, prod: Int8Product, zp: int) -> torch.Tensor:
    """Dense ``k*k`` int8 conv as ONE GEMM over the ``k^2`` shifted views
    concatenated along channels (``[B*oh*ow, k^2*Cin]``, (ky, kx, cin)
    order) against the ``"im2col"``-packed weight. Exact; any stride and
    dilation."""
    if prod.route != "im2col" or node.attrs["groups"] != 1:
        raise ValueError("int8_conv_im2col takes a dense conv packed for 'im2col'")
    return int8_conv(xq, node, prod, zp)


def b2s_applicable(node, h: int) -> bool:
    """Whether the batch-to-space fold is exact for this conv at input
    height ``h``: no dilation, ``k >= s``, a padding (the seam is the
    per-image padding) and ``(h + 2p) % s == 0``."""
    a = node.attrs
    kh, _ = a["kernel"]
    sh, _ = a["stride"]
    ph, _ = a["padding"]
    return a["dilation"] == (1, 1) and kh >= sh and ph > 0 and (h + 2 * ph) % sh == 0


def int8_conv_b2s(xq: torch.Tensor, node, prod: Int8Product, zp: int) -> torch.Tensor:
    """Batch-to-space fold of an int8 conv: each image zero-point padded,
    the padded images stacked along H into one ``B*(H+2p)``-tall image (and
    ``k - s`` more zp rows), one VALID conv over the stack, and the
    ``(2p + k - s)/s`` rows computed across each seam dropped after an
    exact reshape. Every block is ``H + 2p`` rows, a multiple of the
    stride, so block ``i``'s first ``out_h`` rows are image ``i``'s conv.
    Needs :func:`b2s_applicable`; ``prod`` packed for ``"b2s"``."""
    a = node.attrs
    kh, _ = a["kernel"]
    sh, _ = a["stride"]
    ph, pw = a["padding"]
    b, h, w, c = xq.shape
    hp = h + 2 * ph
    xf = _zp_pad(xq, node, zp).reshape(1, b * hp, w + 2 * pw, c)
    if kh > sh:  # trailing zp rows: the VALID conv emits exactly b * hp / s rows
        xf = F.pad(xf, (0, 0, 0, 0, 0, kh - sh), value=zp)
    acc = _conv_valid(xf, node, prod)
    out_h = (hp - kh) // sh + 1
    return acc.reshape(b, hp // sh, acc.shape[2], acc.shape[3])[:, :out_h]


def int8_linear(xq: torch.Tensor, prod: Int8Product) -> torch.Tensor:
    """int8 ``[..., K]`` times the packed ``[N, K]`` weight -> int32 ``[..., N]``."""
    lead = xq.shape[:-1]
    x2 = xq.reshape(-1, xq.shape[-1])
    if prod.route == "f64":
        acc = (x2.to(torch.float64) @ prod.w.reshape(prod.n_out, -1).t()).to(torch.int32)
    else:
        acc = int_mm_exact(x2, prod.w[0, 0])[:, :prod.n_out]
    return acc.reshape(lead + (prod.n_out,))


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@dataclasses.dataclass
class _Piece:
    """Output channels ``[c0, c0 + n)`` of a lowered layer on ``device``:
    the packed exact product, ``wsum``, the combined scale ``in_scale *
    w_scale`` (numpy f32, as the JAX engine's host product) and the bias.
    A grouped conv's piece reads the input channels of the groups it
    spans (``cin``) and drops the rows it pads to whole groups (``keep``)."""

    node: Any
    prod: Int8Product
    wsum: torch.Tensor
    comb: torch.Tensor
    bias: Optional[torch.Tensor]
    cin: Optional[slice] = None
    keep: Optional[slice] = None

    @classmethod
    def build(cls, node, qweight, wsum, w_scale, bias, in_scale, device, c0: int = 0):
        dev = torch.device(device)
        n, cin, keep = qweight.shape[0], None, None
        groups = node.attrs.get("groups", 1) if node.op == "conv" else 1
        if groups > 1 and n != node.attrs["out_ch"]:
            opg = node.attrs["out_ch"] // groups
            g0, g1 = c0 // opg, -(-(c0 + n) // opg)
            front, back = c0 - g0 * opg, g1 * opg - (c0 + n)
            qweight = np.pad(qweight, ((front, back), (0, 0), (0, 0), (0, 0)))
            cin_g = qweight.shape[1]
            cin, keep = slice(g0 * cin_g, g1 * cin_g), slice(front, front + n)
            node = node.replace(attrs={**node.attrs, "groups": g1 - g0,
                                       "in_ch": (g1 - g0) * cin_g, "out_ch": qweight.shape[0]})

        def t(a, dtype):
            return torch.as_tensor(np.asarray(a)).to(device=dev, dtype=dtype).contiguous()

        return cls(node, pack_int8_product(qweight, node, dev), t(wsum, torch.int32),
                   t(np.asarray(in_scale * np.asarray(w_scale, np.float32), np.float32),
                     torch.float32),
                   None if bias is None else t(bias, torch.float32), cin, keep)

    def __call__(self, xq: torch.Tensor, zp: int) -> torch.Tensor:
        dev = self.wsum.device
        x = xq if self.cin is None else xq[..., self.cin]
        x = x.to(dev)
        if self.node.op == "conv":
            acc = int8_conv(x, self.node, self.prod, zp)
        else:
            acc = int8_linear(x, self.prod)
        if self.keep is not None:
            acc = acc[..., self.keep]
        a = (acc - zp * self.wsum).to(torch.float32)
        return a * self.comb if self.bias is None else fma_f32(a, self.comb, self.bias)


# ops whose inputs the baseline engine fake-quantizes at their sites
_SITE_OPS = {"conv", "linear", "add", "concat", "global_mean", "interpolate",
             "softmax", "l2norm"}


class Int8Net(nn.Module):
    """The baseline int8 engine (``execute_int8``) as a module on one
    device: every lowered layer's int8 weights, ``wsum``, combined scales
    and bias, and the residual f32 params, are packed once here.
    ``device=None`` means CUDA, and raises without it.

    The f32 glue mirrors the forms XLA compiles the JAX engine into
    (``dfq_tpu_torch/ops/rounding.py``): the input quantize multiplies by
    ``f32(1/f32(in_scale))``; the epilogue ``f32(acc) * (in_scale *
    w_scale) + bias`` is one FMA; a spatial mean is a sequential f32 sum,
    whose ``1/n`` folds into the quantize of a lowered consumer; site
    fake-quants are :func:`~dfq_tpu_torch.quant.core.fake_quant`.

    ``weights`` overrides the lowered int8 constants, as the JAX engine's
    ``weights=`` (its tensor-parallel entry): ``{name: {"qweight", "wsum",
    "scale", "bias"}}`` in its layouts (conv ``qweight`` HWIO, linear
    ``[in, out]``, so the last dim is the output channel). A value may be
    a list: the layer's output channels in consecutive shards, each on the
    device that computes it (``parallel/tp.py``). Each shard computes its
    channels from the whole input (a grouped conv: from the input channels
    its groups read), its epilogue runs on its device, and the shards are
    concatenated on this module's device before the next node: per
    channel the same operations as the unsharded layer, so the outputs are
    bit-equal.
    """

    def __init__(self, model: Int8Model, params_f32: Dict[str, Dict], device=None,
                 weights: Optional[Dict[str, Dict[str, Any]]] = None):
        super().__init__()
        self.device = resolve_device(device)
        self.model = model
        self.weights = weights or {}
        self.params = params_to(params_f32, self.device)
        graph = model.graph
        self.input_name = graph.input_names()[0]
        self.outputs = graph.outputs
        self._qmax = 2.0**model.bits_act - 1.0
        # the packed exact int8 product of every lowered layer (but those a
        # weights override splits into shards)
        self.products: Dict[str, Int8Product] = {}
        # global_mean nodes whose one consumer is a lowered layer: they hand
        # it the spatial sum, and it folds 1/n into its quantize
        self._sum_only = {
            n.name for n in graph
            if n.op == "global_mean" and n.name not in graph.outputs
            and len(graph.consumers(n.name)) == 1
            and graph.consumers(n.name)[0] in model.layers
            and graph[graph.consumers(n.name)[0]].inputs[0] == n.name
        }
        self._steps = [(n.name, self._build(n)) for n in graph if n.op != "input"]

    def _site_fq(self, node, i, val):
        key = f"{node.name}:in{i}"
        if key in self.model.act_ranges:
            lo, hi = self.model.act_ranges[key]
            val = fake_quant(val, lo, hi, bits=self.model.bits_act)
        return val

    def _build(self, node):
        name = node.name
        if node.op in ("conv", "linear") and name in self.model.layers:
            return self._build_layer(node)
        if node.op == "global_mean":
            return self._build_mean(node)
        p = self.params.get(name, {})
        quantized = node.op in _SITE_OPS

        def f32_op(env, node=node, p=p):
            ins = [env[i] for i in node.inputs]
            if quantized:
                ins = [self._site_fq(node, i, v) for i, v in enumerate(ins)]
            env[node.name] = apply_op(node, ins, p)

        return f32_op

    def _build_mean(self, node):
        """Spatial mean of the site fake-quant, as XLA:CPU fuses it. Where
        the site's range starts at 0, XLA drops the ``- 0`` and ``+ 0`` and
        contracts each term's dequant multiply into the running sum:
        ``acc = fma(q, s, acc)`` (in :func:`_spatial_sum`'s order).
        Otherwise the fake-quant values are summed in order. ``1/n``
        folds into a lowered consumer's quantize."""
        name, src = node.name, node.inputs[0]
        n_sum = name in self._sum_only
        rng = self.model.act_ranges.get(f"{name}:in0")
        contract = rng is not None and f32(rng[0]) == 0.0

        def mean(env):
            x = env[src]
            if contract:
                scale = f32(max((rng[1] - rng[0]) / self._qmax, 1e-8))
                q = torch.round(torch.clamp(x * recip_xla(scale), 0.0, self._qmax))
                acc = _spatial_sum(q, scale)
            else:
                acc = _spatial_sum(self._site_fq(node, 0, x))
            n = x.shape[1] * x.shape[2]
            env[name] = (acc, n) if n_sum else acc * f32(np.float32(1) / np.float32(n))

        return mean

    def _pieces(self, node, layer: Int8Layer) -> List["_Piece"]:
        """The layer's product and epilogue in output-channel pieces: one
        on this module's device, or one per shard of a ``weights``
        override."""
        ov = self.weights.get(node.name)
        if ov is None:
            return [_Piece.build(node, layer.qweight, layer.wsum, layer.w_scale, layer.bias,
                                 layer.in_scale, self.device)]
        sharded = isinstance(ov["qweight"], (list, tuple))
        shards = [{k: (v[i] if sharded and v is not None else v) for k, v in ov.items()}
                  for i in range(len(ov["qweight"]) if sharded else 1)]
        pieces, c0 = [], 0
        for sh in shards:
            qw = _host(sh["qweight"])
            # HWIO -> OIHW; [in, out] -> [out, in]
            qw = qw.transpose(3, 2, 0, 1) if qw.ndim == 4 else qw.T
            if qw.shape[0] == 0:  # a shard of no channels computes nothing
                continue
            dev = (sh["qweight"].device if isinstance(sh["qweight"], torch.Tensor)
                   else self.device)
            bias = None if sh.get("bias") is None else _host(sh["bias"])
            pieces.append(_Piece.build(node, qw, _host(sh["wsum"]), _host(sh["scale"]), bias,
                                       layer.in_scale, dev, c0))
            c0 += qw.shape[0]
        if c0 != layer.qweight.shape[0]:
            raise ValueError(f"{node.name}: the weights override has {c0} output channels, "
                             f"the layer {layer.qweight.shape[0]}")
        return pieces

    def _build_layer(self, node):
        layer = self.model.layers[node.name]
        pieces = self._pieces(node, layer)
        if len(pieces) == 1:
            self.products[node.name] = pieces[0].prod
        zp, qmax = layer.in_zp, self._qmax
        r = recip_xla(layer.in_scale)
        src = node.inputs[0]
        folded = src in self._sum_only
        home = self.device

        def lowered(env):
            x = env[src]
            if folded:  # round(mean / s): sum * f32(f32(1/n) * f32(1/s))
                acc_sum, n = x
                xq = quant_u8(acc_sum, mean_quant_recip(n, layer.in_scale), zp, 0.0, qmax)
            else:
                xq = quant_u8(x, r, zp, 0.0, qmax)
            outs = [pc(xq, zp).to(home) for pc in pieces]
            env[node.name] = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)

        return lowered

    def forward(self, x: torch.Tensor):
        """``x``: f32 NHWC images -> f32 logits (or a tuple of outputs)."""
        env: Dict[str, Any] = {self.input_name: x.to(self.device)}
        with highest_precision():
            for _, step in self._steps:
                step(env)
        outs = tuple(env[o] for o in self.outputs)
        return outs[0] if len(outs) == 1 else outs


def _spatial_sum(x: torch.Tensor, scale: Optional[float] = None) -> torch.Tensor:
    """Sum over (h, w) of NHWC f32, sequentially in f32, as XLA:CPU
    reduces a spatial mean; with ``scale``, ``x`` holds grid values ``q``
    and each term is ``fma(q, scale, acc)``. There, at heights 2, 4 and 8
    LLVM unrolls the loop over rows: each row is its own sequential chain
    and the rows are added as a halving tree (row ``i`` with row
    ``i + H/2``, and so on; measured on XLA:CPU at widths 2-8). At height
    16 (read from its LLVM IR) it vectorizes the rows in two blocks of 8
    lanes: lane ``i`` sums the rounded products ``q * scale`` of row ``i``
    in order, then of row ``i + 8``, and the 8 lanes are added as a halving
    tree."""
    _, H, W, _ = x.shape
    if scale is not None and H == 16:
        terms = x * scale
        lanes = terms[:, :8, 0]
        for i in range(1, 2 * W):
            lanes = lanes + terms[:, 8 * (i // W):8 * (i // W) + 8, i % W]
        while lanes.shape[1] > 1:
            half = lanes.shape[1] // 2
            lanes = lanes[:, :half] + lanes[:, half:]
        return lanes[:, 0]
    if scale is not None and H in (2, 4, 8):
        rows = [_spatial_sum(x[:, h:h + 1], scale) for h in range(H)]
        while len(rows) > 1:
            half = len(rows) // 2
            rows = [rows[i] + rows[i + half] for i in range(half)]
        return rows[0]
    acc = x[:, 0, 0] if scale is None else x[:, 0, 0] * scale
    for i in range(1, H * W):
        v = x[:, i // W, i % W]
        acc = acc + v if scale is None else fma_f32(v, scale, acc)
    return acc


def execute_int8(model: Int8Model, params_f32, x: torch.Tensor, device=None, weights=None):
    """The JAX package's ``execute_int8`` by name: builds an
    :class:`Int8Net` (with the ``weights`` override, the tensor-parallel
    entry) and runs ``x`` through it. Build the module once to run many
    batches."""
    with torch.no_grad():
        return Int8Net(model, params_f32, device=device, weights=weights)(x)
