"""The quantized model's arithmetic in float64: the plain reference.

A configuration's model is defined by the DFQ passes (``dfq/``, frozen),
then by int8 lowering: every conv and linear layer whose input is a
quantizer site gets per-output-channel symmetric weights of
``bits_weight`` bits, its bias on the ``bits_bias`` grid, and the site's
activation grid. An edge that carries an integer tensor carries it on
the grid of its LAST quantized consumer site (reached through ReLU and
folded-BN nodes); every other consumer rounds it again onto its own
grid. That is the program's documented semantics
(``Int8FusedNet``'s consumer plan), written here as plain roundings of
real numbers: ``Q(v, grid)`` rounds ``v`` onto the grid and returns the
real value it stands for.

The parameter-free spatial ops follow the program's documented
semantics (``graph/executor.py``'s maths, ``Int8FusedNet``'s grids):

- ``maxpool`` pools the carried real values with -inf padding and keeps
  their grid (the engine pools the int8 codes, which keeps the order);
  each consumer rounds onto its own grid, as the engine's requantizes. A
  real input is pooled and emitted.
- ``pad`` pads with real 0, the zero point of any grid, and keeps the grid.
- ``interpolate`` rounds its input at its site, resizes (bilinear only,
  with the node's ``align_corners``) and emits. The program sums the two
  taps of each axis in float32 in XLA:CPU's order; here they are summed
  in float64, so it departs from the program by float32 round-off.
- ``global_pool`` takes the mean over H and W keeping a 1x1 map, with its
  input rounded at its site if it has one (the program's graphs give it
  none), and emits.

The reference computes in float64 with plain ``torch`` operations (no
TF32, no kernels, no batching beyond blocks of rows), so it differs from
the program only where a value lies within float32 round-off of a
rounding boundary. ``bits`` below 8 gives the lower-precision control.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .dfq.ir import Graph
from .dfq.prepare import Prepared
from .dfq.quant import fake_quant_np

Grid = Tuple[float, int, int]  # (scale, unsigned zero point, qmax)

# ops through which a consumer's grid reaches back to the producer
PASSTHROUGH = {"relu", "relu6", "bn", "identity", "dropout", "maxpool"}
# one-input ops whose input 0 is rounded at its site when run in float
FLOAT_SITE_OPS = {"conv", "linear", "global_mean", "interpolate", "softmax", "l2norm"}


def site_grid(lo: float, hi: float, bits: int) -> Grid:
    qmax = 2**bits - 1
    scale = max((hi - lo) / qmax, 1e-8)
    return scale, int(np.clip(np.round(-lo / scale), 0, qmax)), qmax


def Q(v: torch.Tensor, g: Grid) -> torch.Tensor:
    s, zp, qmax = g
    return (torch.clamp(torch.round(v / s) + zp, 0, qmax) - zp) * s


@dataclasses.dataclass
class Layer:
    qweight: np.ndarray  # integers, OIHW or [out, in]
    w_scale: np.ndarray  # [out]
    bias: Optional[np.ndarray]
    grid: Grid  # the input's


@dataclasses.dataclass
class QModel:
    graph: Graph
    layers: Dict[str, Layer]
    sites: Dict[str, Grid]
    plan: Dict[str, Optional[Grid]]


def lower(prep: Prepared, bits: int) -> QModel:
    """Int8 lowering of a prepared model at ``bits`` for weights and
    activations (8 states the configuration; 4 is the control)."""
    sites = {k: site_grid(lo, hi, bits) for k, (lo, hi) in prep.act_ranges.items()}
    layers: Dict[str, Layer] = {}
    qmax_w = 2.0 ** (bits - 1) - 1.0
    for node in prep.graph:
        key = f"{node.name}:in0"
        if node.op not in ("conv", "linear") or key not in sites:
            continue
        p = prep.params_fp[node.name]
        w = np.asarray(p["weight"], np.float32)
        amax = np.abs(w.reshape(w.shape[0], -1)).max(axis=1)
        scale = np.maximum(amax / qmax_w, 1e-12).astype(np.float32)
        q = np.clip(np.round(w / scale.reshape((-1,) + (1,) * (w.ndim - 1))), -qmax_w - 1, qmax_w)
        bias = p.get("bias")
        if bias is not None:
            bias = np.asarray(bias, np.float32)
            if prep.cfg.bits_bias < 32 and bias.size:
                bias = fake_quant_np(bias, float(bias.min()), float(bias.max()),
                                     bits=prep.cfg.bits_bias)
        layers[node.name] = Layer(q, scale, bias, sites[key])
    model = QModel(prep.graph, layers, sites, {})
    model.plan = consumer_plan(model)
    return model


def consumer_plan(model: QModel) -> Dict[str, Optional[Grid]]:
    """The grid each node's output is carried on (None: a real number)."""
    plan: Dict[str, Optional[Grid]] = {}
    for node in reversed(list(model.graph)):
        for idx, inp in enumerate(node.inputs):
            if node.name in model.layers and idx == 0:
                g = model.layers[node.name].grid
            else:
                g = model.sites.get(f"{node.name}:in{idx}")
            if g is None and node.op in PASSTHROUGH:
                g = plan.get(node.name)
            if inp not in plan or (plan[inp] is None and g is not None):
                plan[inp] = g
    return plan


class Reference:
    """The lowered model's float64 forward on ``device``."""

    def __init__(self, model: QModel, device):
        self.model = model
        self.device = torch.device(device)
        dev, f64 = self.device, torch.float64
        self.weights = {}
        for name, L in model.layers.items():
            w = torch.as_tensor(L.qweight, dtype=f64, device=dev)
            s = torch.as_tensor(L.w_scale, dtype=f64, device=dev)
            b = None if L.bias is None else torch.as_tensor(L.bias, dtype=f64, device=dev)
            self.weights[name] = (w, s, b)

    def _layer(self, node, x: torch.Tensor) -> torch.Tensor:
        w, s, b = self.weights[node.name]
        if node.op == "linear":
            out = x @ w.t()
        else:
            a = node.attrs
            out = F.conv2d(x.permute(0, 3, 1, 2), w, stride=a["stride"], padding=a["padding"],
                           dilation=a["dilation"], groups=a["groups"]).permute(0, 2, 3, 1)
        out = out * s
        return out if b is None else out + b

    @torch.no_grad()
    def __call__(self, x) -> Tuple[torch.Tensor, ...]:
        """``x``: NHWC images -> the graph's outputs, float64."""
        m = self.model
        plan = m.plan

        def emit(v, name):
            g = plan.get(name)
            return (v, None) if g is None else (Q(v, g), g)

        env = {m.graph.input_names()[0]: (torch.as_tensor(x, device=self.device).double(), None)}
        for node in m.graph:
            op, name = node.op, node.name
            if op == "input":
                continue
            srcs = [env[i] for i in node.inputs]
            if op in ("conv", "linear") and name in m.layers:
                env[name] = emit(self._layer(node, Q(srcs[0][0], m.layers[name].grid)), name)
            elif op in ("bn", "identity", "dropout"):
                env[name] = srcs[0]  # folded
            elif op in ("relu", "relu6"):
                v, g = srcs[0]
                if g is None:
                    env[name] = emit(torch.relu(v) if op == "relu" else v.clamp(0.0, 6.0), name)
                    continue
                s, zp, qmax = g
                top = qmax if op == "relu" else int(np.clip(np.round(6.0 / s) + zp, 0, qmax))
                v = torch.clamp(v, 0.0, (top - zp) * s)
                g2 = plan.get(name)
                env[name] = (Q(v, g2), g2) if g2 is not None and g2 != g else (v, g)
            elif op == "add":
                ins = []
                for i, (v, g) in enumerate(srcs):
                    sg = m.sites.get(f"{name}:in{i}")
                    ins.append(Q(v, sg) if g is not None and sg is not None else v)
                env[name] = emit(ins[0] + ins[1], name)
            elif op in ("global_mean", "global_pool"):
                sg = m.sites.get(f"{name}:in0")
                v = srcs[0][0] if sg is None else Q(srcs[0][0], sg)
                env[name] = emit(v.mean(dim=(1, 2), keepdim=op == "global_pool"), name)
            elif op in ("maxpool", "pad"):
                v, g = srcs[0]
                a = node.attrs
                if op == "maxpool":
                    v = F.max_pool2d(v.permute(0, 3, 1, 2), a["window"], a["stride"],
                                     a["padding"]).permute(0, 2, 3, 1)
                else:
                    t, b, l, r = a["pads"]
                    v = F.pad(v, (0, 0, l, r, t, b))
                env[name] = (v, g) if g is not None else emit(v, name)
            elif op == "interpolate":
                a = node.attrs
                if a.get("mode", "bilinear") != "bilinear":
                    raise NotImplementedError(f"reference: {a['mode']} resize ({name})")
                sg = m.sites.get(f"{name}:in0")
                v = srcs[0][0] if sg is None else Q(srcs[0][0], sg)
                size = a["size"] or (int(v.shape[1] * a["scale"]), int(v.shape[2] * a["scale"]))
                v = F.interpolate(v.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                                  align_corners=a.get("align_corners", True))
                env[name] = emit(v.permute(0, 2, 3, 1), name)
            elif op == "concat":
                sgs = [m.sites.get(f"{name}:in{i}") for i in range(len(srcs))]
                ins = [v if sg is None else Q(v, sg) for (v, _), sg in zip(srcs, sgs)]
                out = torch.cat(ins, dim=node.attrs.get("axis", -1))
                env[name] = emit(out, name)
            elif op in ("reshape", "softmax"):
                v = srcs[0][0]
                sg = m.sites.get(f"{name}:in0") if op in FLOAT_SITE_OPS else None
                if sg is not None:
                    v = Q(v, sg)
                if op == "reshape":
                    out = v.reshape((v.shape[0],) + tuple(node.attrs["shape"]))
                else:
                    out = torch.softmax(v, dim=node.attrs.get("axis", -1))
                env[name] = emit(out, name)
            else:
                raise NotImplementedError(f"reference: op {op!r} ({name})")
        return tuple(env[o][0] for o in m.graph.outputs)
