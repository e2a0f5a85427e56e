"""The f32 fake-quant simulator (port of ``dfq_tpu/graph/executor.py``).

:func:`execute` interprets the graph IR eagerly on one device: NHWC
activations, OIHW conv weights, convs through ``F.conv2d`` and products
through ``torch.matmul`` with TF32 off (the JAX package's
``Precision.HIGHEST``: the simulation's accuracy contract needs full f32
math). Where ``act_ranges`` has a range for a quantizer site, that
input is fake-quantized (:func:`~dfq_tpu_torch.quant.core.fake_quant`).

Capture modes, as in the JAX package:

- ``capture="bn_inputs"``: also return per-(sample, channel) mean and
  unbiased std of every BN input (and of every folded BN's input);
- ``capture="minmax"``: also return per site (mean of per-sample min,
  mean of per-sample max);
- ``capture="layer_outputs"``: also return every conv/linear output's
  per-channel mean over batch and space.

The op helpers (:func:`apply_op` and the ones it calls) are shared with
the int8 engines' f32 paths.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dfq_tpu_torch.device import resolve_device
from dfq_tpu_torch.graph.ir import Graph, node_sites
from dfq_tpu_torch.ops.rounding import f32, fma_f32, recip_xla
from dfq_tpu_torch.quant.core import fake_quant

Params = Dict[str, Dict[str, torch.Tensor]]

# ops whose inputs are quantizer sites in the simulator
SITE_OPS = {"conv", "linear", "add", "concat", "global_mean", "interpolate", "softmax"}


@contextlib.contextmanager
def highest_precision():
    """Full-f32 convs and products on CUDA (no TF32), restored on exit."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def params_to(params: Dict[str, Dict[str, Any]], device, dtype=None) -> Params:
    """Every leaf of a params dict as a tensor on ``device`` (a leaf already
    there is not copied): of ``dtype`` if given, else f32 for host arrays
    while a tensor keeps its floating dtype (distillation's bf16 params)."""
    dev = resolve_device(device)

    def leaf(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=dtype or (v.dtype if v.is_floating_point()
                                                    else torch.float32))
        return torch.as_tensor(np.asarray(v), dtype=dtype or torch.float32, device=dev)

    return {k: {n: leaf(v) for n, v in p.items()} for k, p in params.items()}


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _conv(x: torch.Tensor, node, p) -> torch.Tensor:
    a = node.attrs
    out = _nhwc(F.conv2d(_nchw(x), p["weight"].to(x.dtype), stride=a["stride"],
                         padding=a["padding"], dilation=a["dilation"], groups=a["groups"]))
    b = p.get("bias")
    return out if b is None else out + b.to(out.dtype)


def _linear(x: torch.Tensor, node, p) -> torch.Tensor:
    out = torch.matmul(x, p["weight"].t().to(x.dtype))
    b = p.get("bias")
    return out if b is None else out + b.to(out.dtype)


def _bn(x: torch.Tensor, node, p) -> torch.Tensor:
    eps = node.attrs.get("eps", 1e-5)
    inv = torch.rsqrt(p["var"] + eps)
    return (x - p["mean"]) * inv * p["gamma"] + p["beta"]


def _pool(x: torch.Tensor, node, kind: str) -> torch.Tensor:
    a = node.attrs
    if kind == "max":  # -inf padding
        out = F.max_pool2d(_nchw(x), a["window"], a["stride"], a["padding"])
    else:  # count_include_pad=True: the window's sum over wh * ww
        out = F.avg_pool2d(_nchw(x), a["window"], a["stride"], a["padding"],
                           count_include_pad=True)
    return _nhwc(out)


# input lengths at which XLA:CPU sums a bilinear resize's two taps as
# ``fma(w1, x1, f32(w0 * x0))``; at the others (4-8, 10-12, 17-19, 33, 65,
# 129, measured) as ``f32(w0 * x0) + f32(w1 * x1)`` (jax 0.9, the JAX
# package's matmul form; tests/test_torch_deeplab.py)
RESIZE_FMA_LENGTHS = frozenset({2, 3, 9, 13, 14, 15, 16, 31, 32, 64})


def _resize_taps(in_len: int, out_len: int, align_corners: bool, device):
    """Each output coordinate's two input indices and weights ``(i0, i1,
    w0, w1)``: the taps of the JAX package's interpolation matrix."""
    if align_corners and out_len > 1:
        cs = torch.linspace(0.0, in_len - 1.0, out_len, device=device)
    else:
        scale = in_len / out_len
        cs = torch.clamp((torch.arange(out_len, device=device) + 0.5) * scale - 0.5,
                         0.0, in_len - 1.0)
    i0 = torch.floor(cs).long()
    i1 = torch.clamp(i0 + 1, max=in_len - 1)
    w1 = cs - i0
    return i0, i1, 1.0 - w1, w1


def _resize_axis(x: torch.Tensor, axis: int, out_len: int, align_corners: bool):
    """Bilinear resize of NHWC ``x`` along ``axis`` (1 or 2) by gathering
    the two taps and summing them in XLA:CPU's form for this length."""
    in_len = x.shape[axis]
    i0, i1, w0, w1 = _resize_taps(in_len, out_len, align_corners, x.device)
    shape = [1, 1, 1, 1]
    shape[axis] = out_len
    w0, w1 = w0.reshape(shape), w1.reshape(shape)
    p0 = x.index_select(axis, i0) * w0
    x1 = x.index_select(axis, i1)
    if in_len in RESIZE_FMA_LENGTHS:
        return fma_f32(x1, w1, p0)
    return p0 + x1 * w1


def _resize_bilinear(x: torch.Tensor, out_size, align_corners: bool) -> torch.Tensor:
    """Separable bilinear resize, rows then columns, as the JAX package's
    two interpolation-matrix products compute it, in f32 (a bf16 map is
    promoted, as JAX promotes it)."""
    oh, ow = out_size
    rows = _resize_axis(x.float(), 1, oh, align_corners)
    return _resize_axis(rows, 2, ow, align_corners)


def _interpolate(x: torch.Tensor, node) -> torch.Tensor:
    a = node.attrs
    if a.get("size") is not None:
        out_size = a["size"]
    else:
        out_size = (int(x.shape[1] * a["scale"]), int(x.shape[2] * a["scale"]))
    if a.get("mode", "bilinear") == "nearest":
        _, h, w, _ = x.shape
        oh, ow = out_size
        # (arange * (h / oh)) in f32, truncated, as the JAX package
        yi = (torch.arange(oh, dtype=torch.float32, device=x.device) * f32(h / oh)).long()
        xi = (torch.arange(ow, dtype=torch.float32, device=x.device) * f32(w / ow)).long()
        return x.index_select(1, yi).index_select(2, xi)
    return _resize_bilinear(x, out_size, a.get("align_corners", True))


def _per_sample_minmax(v: torch.Tensor):
    flat = v.reshape(v.shape[0], -1)
    return flat.amin(-1).mean(), flat.amax(-1).mean()


def _input_stats(v: torch.Tensor):
    """Per-(sample, channel) mean and unbiased std (eps inside the sqrt)."""
    red = tuple(range(1, v.ndim - 1))
    n_el = int(np.prod([v.shape[a] for a in red]))
    mean = v.mean(dim=red)
    var = torch.var(v, dim=red, correction=0) * (n_el / max(n_el - 1, 1))
    return mean, torch.sqrt(var + 1e-8)


def apply_op(node, ins, p) -> torch.Tensor:
    """The f32 semantics of one node on inputs already fake-quantized at
    its sites (every op but the BN/identity capture hooks)."""
    op = node.op
    if op == "conv":
        return _conv(ins[0], node, p)
    if op == "linear":
        return _linear(ins[0], node, p)
    if op == "bn":
        return _bn(ins[0], node, p)
    if op in ("identity", "dropout"):
        return ins[0]
    if op == "relu":
        return torch.relu(ins[0])
    if op == "relu6":
        return torch.clamp(ins[0], 0.0, 6.0)
    if op == "add":
        return ins[0] + ins[1]
    if op == "concat":
        return torch.cat(ins, dim=node.attrs.get("axis", -1))
    if op == "global_mean":
        return ins[0].mean(dim=(1, 2))
    if op == "global_pool":
        return ins[0].mean(dim=(1, 2), keepdim=True)
    if op == "avgpool":
        return _pool(ins[0], node, "avg")
    if op == "maxpool":
        return _pool(ins[0], node, "max")
    if op == "pad":
        t, b, l, r = node.attrs["pads"]
        return F.pad(ins[0], (0, 0, l, r, t, b))
    if op == "interpolate":
        return _interpolate(ins[0], node)
    if op == "softmax":
        return torch.softmax(ins[0], dim=node.attrs.get("axis", -1))
    if op == "l2norm":
        # F.normalize(p=2, dim=channel) * scale: v / max(||v||, eps)
        v = ins[0]
        norm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
        return v / torch.clamp(norm, min=1e-12) * p["scale"]
    if op == "reshape":
        v = ins[0]
        return v.reshape((v.shape[0],) + tuple(node.attrs["shape"]))
    if op == "permute_nchw":
        # logical-NCHW permute applied to an NHWC tensor
        return _nchw(ins[0]).permute(*node.attrs["perm"])
    raise NotImplementedError(f"op {op!r}")


def _fake_quant_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-tensor min/max fake-quant of a weight, in the form XLA's
    constant folding evaluates the JAX package's (params closed over by
    ``jit``): f32 scale ``span * f32(1/qmax)``, division, and a separate
    multiply and add."""
    mn, mx = w.min(), w.max()
    qmax = 2.0**bits - 1.0
    scale = ((mx - mn) * recip_xla(qmax)).clamp_min(1e-8)
    q = torch.round(torch.clamp((w - mn) / scale, 0.0, qmax))
    return q * scale + mn


def site_value(node, i: int, val: torch.Tensor, act_ranges, bits_act: int,
               capture: Optional[str] = None, self_quant: bool = False,
               aux: Optional[Dict[str, Any]] = None) -> torch.Tensor:
    """Input ``i`` of ``node`` as the simulator feeds it: captured
    (``minmax``), fake-quantized with its batch's range (``self_quant``)
    or with its range in ``act_ranges``, or unchanged."""
    key = f"{node.name}:in{i}"
    is_site = key in node_sites(node)
    if capture == "minmax" and is_site:
        aux[key] = _per_sample_minmax(val)
    if self_quant and is_site:
        mn, mx = aux[key] if aux and key in aux else _per_sample_minmax(val)
        return fake_quant(val, mn, mx, bits=bits_act)
    if key in act_ranges:
        mn, mx = act_ranges[key]
        val = fake_quant(val, mn, mx, bits=bits_act)
    return val


def layer_params(node, p, weight_bits: Optional[int], bias_bits: int):
    """A conv/linear node's params as the simulator uses them: under
    ``weight_bits`` (the ``--trainable`` regime) the weight fake-quantized
    with its per-tensor min/max, and the bias with ``bias_bits`` (not at
    32)."""
    if weight_bits is None or node.op not in ("conv", "linear"):
        return p
    p = dict(p)
    p["weight"] = _fake_quant_weight(p["weight"], weight_bits)
    b = p.get("bias")
    if b is not None and bias_bits < 32:
        p["bias"] = _fake_quant_weight(b, bias_bits)
    return p


def execute(
    graph: Graph,
    params: Dict[str, Dict[str, Any]],
    x: torch.Tensor,
    *,
    act_ranges: Optional[Dict[str, Tuple[Any, Any]]] = None,
    bits_act: int = 8,
    capture: Optional[str] = None,
    self_quant: bool = False,
    weight_bits: Optional[int] = None,
    bias_bits: int = 16,
    device=None,
):
    """Run the graph on ``device`` (CUDA unless the caller asks for the
    CPU). ``x``: f32 NHWC; ``params``: numpy arrays or tensors
    (:func:`params_to` moves them once). Returns the output (or a tuple of
    outputs), plus an aux dict when ``capture`` is set.

    ``act_ranges`` maps site key -> (min, max): that input is
    fake-quantized with ``bits_act`` bits. ``self_quant`` quantizes every
    site with its batch's mean-of-per-sample min/max instead.
    ``weight_bits`` is the ``--trainable`` regime: conv/linear weights
    fake-quantized per forward with their per-tensor min/max, biases with
    ``bias_bits`` (not at 32).
    """
    dev = resolve_device(device)
    params = params_to(params, dev)
    act_ranges = act_ranges or {}
    aux: Dict[str, Any] = {}
    input_names = graph.input_names()
    if len(input_names) != 1:
        raise NotImplementedError("single-input graphs only")
    env: Dict[str, torch.Tensor] = {input_names[0]: x.to(dev)}
    with highest_precision():
        for node in graph:
            if node.op == "input":
                continue
            op = node.op
            ins = [env[i] for i in node.inputs]
            if op in SITE_OPS:
                n_q = len(node_sites(node))
                ins = [site_value(node, i, v, act_ranges, bits_act, capture, self_quant, aux)
                       if i < n_q else v for i, v in enumerate(ins)]
            p = layer_params(node, params.get(node.name, {}), weight_bits, bias_bits)
            if capture == "bn_inputs" and (
                op == "bn" or (op in ("identity", "dropout") and "stat_std" in p)
            ):
                # statistics of the BN input (a folded BN: its stat buffers
                # are the targets, the input stats are still captured)
                aux[node.name] = _input_stats(ins[0].float())
            out = apply_op(node, ins, p)
            if capture == "layer_outputs" and op in ("conv", "linear"):
                v = out.mean(dim=0)
                if v.ndim > 1:
                    v = v.mean(dim=tuple(range(v.ndim - 1)))
                aux[node.name] = v
            env[node.name] = out

    outs = tuple(env[o] for o in graph.outputs)
    result = outs[0] if len(outs) == 1 else outs
    if capture is not None:
        return result, aux
    return result
