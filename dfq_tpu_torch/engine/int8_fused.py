"""Fused int8-to-int8 execution on the hand-written kernels (port of
``dfq_tpu/engine/int8_fused.py``, configuration ``use_pallas=True,
fuse_blocks=True``).

Each conv's requantization to its consumer's input grid is fused into the
conv epilogue, so inter-layer tensors stay int8:

- pointwise convs and linear layers run on K1 (``matmul_int8_requant``),
  stride-1 depthwise 3x3 convs on K2 (``dw3x3_int8_requant``), and each
  inverted-residual chain ``pw-expand -> relu(6) -> dw3x3 s1 -> relu(6)
  -> pw-project [-> add]`` whose site grids line up on K3
  (``fused_block_int8``) — the three kernels of
  ``dfq_tpu_torch/ops/cuda_int8.py``;
- other convs (MobileNetV2's k3s2 stem and stride-2 depthwise convs) run
  as exact integer convs (:func:`~dfq_tpu_torch.engine.int8._int8_conv`)
  with the same epilogue in plain PyTorch;
- ReLU is a clamp at the zero point and ReLU6 a clamp at quant(6), both in
  the int domain; residual adds dequantize both operands through their
  site grids and requantize; folded BN/identity pass int8 through;
- the spatial mean runs in f32, as in the JAX engine's fallback.

The int8 tensor carried on an edge uses the CONSUMER's site quantization
params (:func:`_consumer_plan`). The f32 glue mirrors the forms XLA
compiles the JAX engine into (``dfq_tpu_torch/ops/rounding.py``), so the
port's logits match the JAX engine's.

The XLA-only policies of the JAX engine (``stem_s2d``, ``dw_dense_*``,
``chpad_k3``, ``k3_matmul``, ``b2s_min_h``, ``auto_config``) are bit-exact
rewrites and are not ported yet (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from dfq_tpu_torch.device import resolve_device
from dfq_tpu_torch.engine.int8 import Int8Model, _int8_conv
from dfq_tpu_torch.graph.ir import Graph
from dfq_tpu_torch.ops import cuda_int8 as kernels
from dfq_tpu_torch.ops.rounding import (
    f32,
    fma_f32,
    mean_quant_recip,
    quant_u8,
    recip_xla,
    requant_i8,
)

Grid = Tuple[float, int]


@dataclasses.dataclass
class QTensor:
    q: torch.Tensor  # int8
    scale: float
    zp: int  # int8-domain zero point

    def dequant(self) -> torch.Tensor:
        return (self.q.to(torch.float32) - self.zp) * f32(self.scale)


def _site_params(model: Int8Model, site: str) -> Optional[Grid]:
    if site not in model.act_ranges:
        return None
    lo, hi = model.act_ranges[site]
    qmax = 2.0**model.bits_act - 1.0
    scale = max((hi - lo) / qmax, 1e-8)
    zp_u = int(np.clip(np.round(-lo / scale), 0, qmax))
    return scale, zp_u - 128


def _quantize_f32(x: torch.Tensor, scale: float, zp: int) -> torch.Tensor:
    # round(x / scale): XLA multiplies by f32(1 / f32(scale))
    return quant_u8(x, recip_xla(scale), zp)


def _requant_i8(t: QTensor, scale: float, zp: int) -> torch.Tensor:
    if t.scale == scale and t.zp == zp:
        return t.q
    # (q - zp) * (s / s') + (zp' + 128) as one FMA; the ratio is Python's
    return requant_i8(t.q, t.zp, f32(t.scale / scale), zp)


# ops through which an output grid propagates backward unchanged
_GRID_PASSTHROUGH = {"relu", "relu6", "bn", "identity", "dropout", "maxpool"}


def _consumer_plan(graph: Graph, model: Int8Model) -> Dict[str, Optional[Grid]]:
    """For each node, the int8 params its output should carry: the params
    of the first quantized consumer site reachable through grid-
    passthrough ops (None -> keep f32). One reverse topological sweep."""
    plan: Dict[str, Optional[Grid]] = {}
    for node in reversed(list(graph)):
        for idx, inp in enumerate(node.inputs):
            sp: Optional[Grid] = None
            if node.name in model.layers and idx == 0:
                layer = model.layers[node.name]
                sp = (layer.in_scale, layer.in_zp)
            else:
                sp = _site_params(model, f"{node.name}:in{idx}")
            if sp is None and node.op in _GRID_PASSTHROUGH:
                sp = plan.get(node.name)
            if inp not in plan or (plan[inp] is None and sp is not None):
                plan[inp] = sp
    return plan


def _find_fusable_blocks(graph: Graph, model: Int8Model, plan):
    """Identify inverted-residual chains
    ``pw-expand -> relu(6) -> dw3x3 s1 -> relu(6) -> pw-project [-> add]``
    whose site grids line up with the consumer plan, so the whole block
    can run as one K3 launch bit-exactly. Returns {expand_name: info}."""

    def walk(name, skips):
        """Next non-identity single consumer; folded-BN/identity/dropout
        nodes pass int8 tensors through unchanged in this engine, so a
        fused chain may span them (they land on the skip list)."""
        while True:
            cs = graph.consumers(name)
            if len(cs) != 1 or name in graph.outputs:
                return None
            n = graph[cs[0]]
            if n.op in ("bn", "identity", "dropout"):
                skips.append(n.name)
                name = n.name
                continue
            return n

    act_hi = {"relu": 3.4e38, "relu6": 6.0}
    blocks = {}
    for node in graph:
        if node.op != "conv" or node.name not in model.layers:
            continue
        a = node.attrs
        if not (
            a["kernel"] == (1, 1) and a["groups"] == 1
            and a["stride"] == (1, 1) and a["padding"] == (0, 0)
        ):
            continue
        skips: List[str] = []
        r1 = walk(node.name, skips)
        if r1 is None or r1.op not in act_hi or r1.name in graph.outputs:
            continue
        dw = walk(r1.name, skips)
        if dw is None or dw.op != "conv" or dw.name not in model.layers:
            continue
        da = dw.attrs
        if not (
            da["kernel"] == (3, 3) and da["groups"] == da["in_ch"]
            and da["stride"] == (1, 1) and da["padding"] == (1, 1)
            and da["dilation"] == (1, 1)
        ):
            continue
        r2 = walk(dw.name, skips)
        if r2 is None or r2.op not in act_hi or r2.name in graph.outputs:
            continue
        pj = walk(r2.name, skips)
        if pj is None or pj.op != "conv" or pj.name not in model.layers:
            continue
        pa = pj.attrs
        if not (
            pa["kernel"] == (1, 1) and pa["groups"] == 1
            and pa["stride"] == (1, 1) and pa["padding"] == (0, 0)
        ):
            continue
        Ld, Lp = (model.layers[n.name] for n in (dw, pj))
        # the engine's grids through the chain must be exactly the next
        # layer's input params (no intermediate requants)
        if plan.get(node.name) != (Ld.in_scale, Ld.in_zp):
            continue
        if plan.get(dw.name) != (Lp.in_scale, Lp.in_zp):
            continue
        xname = node.inputs[0]
        if plan.get(xname) is None or pj.name in graph.outputs:
            continue
        info = {
            "dw": dw.name, "pj": pj.name,
            "skip": skips + [r1.name, dw.name, r2.name],
            "act1_hi": act_hi[r1.op], "act2_hi": act_hi[r2.op],
            "x": xname, "res": None, "p_grid": None, "final": pj.name,
            "out_grid": plan.get(pj.name),
        }
        skips2: List[str] = []
        add = walk(pj.name, skips2)
        p_alias = skips2[-1] if skips2 else pj.name
        if (
            add is not None and add.op == "add"
            and xname in add.inputs and p_alias in add.inputs
            and add.name not in graph.outputs
            and pa["out_ch"] == a["in_ch"]
        ):
            xi = add.inputs.index(xname)
            sp_x = _site_params(model, f"{add.name}:in{xi}")
            sp_p = _site_params(model, f"{add.name}:in{1 - xi}")
            if (
                sp_x is not None and sp_p is not None
                and plan.get(pj.name) == sp_p
            ):
                info.update(
                    res=sp_x, p_grid=sp_p, final=add.name,
                    out_grid=plan.get(add.name),
                )
                info["skip"] += [pj.name] + skips2
        blocks[node.name] = info
    return blocks


def _is_pw(node) -> bool:
    a = node.attrs
    return (node.op == "conv" and a["kernel"] == (1, 1) and a["groups"] == 1
            and a["stride"] == (1, 1) and a["padding"] == (0, 0))


def _is_dw1(node) -> bool:
    a = node.attrs
    return (node.op == "conv" and a["kernel"] == (3, 3) and a["groups"] == a["in_ch"]
            and a["stride"] == (1, 1) and a["padding"] == (1, 1)
            and a["dilation"] == (1, 1))


Step = Callable[[Dict[str, Any], set], None]


class Int8FusedNet(nn.Module):
    """The fused int8 network of an :class:`Int8Model`, on one device.

    Every layer's device operands (transposed or word-packed weights,
    ``wsum``, combined scales, bias, depthwise taps) are packed once here;
    :meth:`forward` then copies nothing to the device but its input.
    ``device=None`` means CUDA, and raises without it; ``device="cpu"``
    runs the kernels' plain versions. ``plain_kernels=True`` runs the
    plain versions on any device, to hold the CUDA kernels against them
    on the card.

    ``kernel_sites`` lists ``(node, kernel name, packed operands)`` of
    every kernel launch a forward makes when every fusable block fits.
    """

    def __init__(self, model: Int8Model, device=None, plain_kernels: bool = False):
        super().__init__()
        if model.bits_act != 8:
            raise ValueError(
                "fused int8 engine requires bits_act=8; "
                f"A{model.bits_act} regimes are not ported"
            )
        self.device = resolve_device(device)
        self.model = model
        graph = model.graph
        self.plan = _consumer_plan(graph, model)
        self.blocks = _find_fusable_blocks(graph, model, self.plan)
        self._fused_away = {n for b in self.blocks.values() for n in b["skip"]}
        self._fused_away.update(b["final"] for b in self.blocks.values())
        self._fused_away.update(self.blocks)
        # kernel name -> its wrapper (launch on CUDA, plain version on the
        # CPU), or its plain version on any device
        impl = "plain" if plain_kernels else "packed"
        self._run = {k: getattr(kernels, f"{k}_{impl}") for k in kernels.LAUNCHES}
        self.kernel_sites: List[Tuple[str, str, Any]] = []
        self.input_name = graph.input_names()[0]
        self.outputs = graph.outputs
        # grid of every node's output as this engine produces it (None:
        # f32); fixed by the plan, so every decision below is static
        self._grids: Dict[str, Optional[Grid]] = {self.input_name: None}
        self._steps: List[Tuple[str, Step]] = []
        for node in graph:
            if node.op != "input":
                self._steps.append((node.name, self._build(node)))

    # -- packing ----------------------------------------------------------
    def _t(self, a, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a)).to(device=self.device, dtype=dtype).contiguous()

    def _bias(self, layer) -> np.ndarray:
        if layer.bias is not None:
            return layer.bias
        return np.zeros(layer.qweight.shape[0], np.float32)

    def _build(self, node) -> Step:
        model, name, op = self.model, node.name, node.op
        grids = self._grids
        if op in ("conv", "linear") and name in model.layers:
            step = self._build_layer(node)
            if name in self.blocks:
                step = self._build_block(node, step)
            grids[name] = self.plan.get(name)
            return step
        if op in ("relu", "relu6"):
            return self._build_act(node)
        if op == "add":
            return self._build_add(node)
        if op in ("bn", "identity", "dropout"):
            src = node.inputs[0]
            grids[name] = grids[src]

            def passthrough(env, done, name=name, src=src):
                env[name] = env[src]  # folded BN is identity

            return passthrough
        if op == "global_mean":
            return self._build_mean(node)
        raise NotImplementedError(f"Int8FusedNet: op {op!r} ({name}) is not ported")

    def _build_layer(self, node) -> Step:
        name = node.name
        layer = self.model.layers[name]
        src = node.inputs[0]
        sp = self.plan.get(name)
        in_grid = (layer.in_scale, layer.in_zp)
        comb = np.asarray(layer.in_scale * layer.w_scale, np.float32)
        get = self._getter(src, in_grid)
        s_out, zp_out = sp if sp is not None else (1.0, 0)
        out_ch = layer.qweight.shape[0]
        if node.op == "linear" or _is_pw(node):
            op = kernels.pack_matmul(
                layer.qweight.reshape(out_ch, -1), comb, self._bias(layer), layer.wsum,
                zp_in=layer.in_zp, s_out=float(s_out), zp_out=int(zp_out),
                out_f32=sp is None, device=self.device)
            self._site(name, "matmul_int8_requant", op)
            run = self._run["matmul_int8_requant"]

            def pw(env, done):
                xq = get(env)
                q = run(xq.reshape(-1, xq.shape[-1]), op)
                self._store(env, name, q.reshape(xq.shape[:-1] + (out_ch,)), sp)

            return pw
        if _is_dw1(node):
            op = kernels.pack_dw3x3(
                layer.qweight[:, 0].reshape(out_ch, 9).T, comb, self._bias(layer),
                zp_in=layer.in_zp, s_out=float(s_out), zp_out=int(zp_out),
                out_f32=sp is None, device=self.device)
            self._site(name, "dw3x3_int8_requant", op)
            run = self._run["dw3x3_int8_requant"]

            def dw(env, done):
                self._store(env, name, run(get(env), op), sp)

            return dw
        # any other conv: exact integer conv + the epilogue in plain torch
        wdtype = torch.float64 if self.device.type == "cpu" else torch.float32
        qw = self._t(layer.qweight, wdtype)
        wsum = self._t(layer.wsum, torch.int32)
        comb_t = self._t(comb, torch.float32)
        bias = None if layer.bias is None else self._t(layer.bias, torch.float32)
        zp = layer.in_zp

        def conv(env, done):
            acc = _int8_conv(get(env), node, qw, zp) - zp * wsum
            a = acc.to(torch.float32)
            # f32(acc) * comb + bias: one FMA under XLA:CPU
            out = a * comb_t if bias is None else fma_f32(a, comb_t, bias)
            self._emit(env, name, out)

        return conv

    def _build_block(self, node, unfused: Step) -> Step:
        """K3 for a fusable block when its input is int8 and the block fits
        the shared-memory budget at this input size; else the unfused
        layer-by-layer path (as ``int8_fused.py:431``)."""
        info = self.blocks[node.name]
        x_grid = self._grids.get(info["x"])
        if x_grid is None:
            return unfused
        m = self.model
        Le, Ld, Lp = m.layers[node.name], m.layers[info["dw"]], m.layers[info["pj"]]
        E = Le.qweight.shape[0]
        C2 = Lp.qweight.shape[0]
        C = Le.qweight.shape[1]
        op = kernels.pack_fused_block(
            Le.qweight.reshape(E, -1).T,
            np.asarray(Le.in_scale * Le.w_scale, np.float32), self._bias(Le), Le.wsum,
            Ld.qweight[:, 0].reshape(E, 9).T,
            np.asarray(Ld.in_scale * Ld.w_scale, np.float32), self._bias(Ld),
            Lp.qweight.reshape(C2, E).T,
            np.asarray(Lp.in_scale * Lp.w_scale, np.float32), self._bias(Lp), Lp.wsum,
            x_grid=x_grid, c1_grid=(Le.in_scale, Le.in_zp),
            e_grid=(Ld.in_scale, Ld.in_zp), d_grid=(Lp.in_scale, Lp.in_zp),
            act1_hi=info["act1_hi"], act2_hi=info["act2_hi"],
            res_grid=info["res"], p_grid=info["p_grid"], out_grid=info["out_grid"],
            device=self.device,
        )
        self.kernel_sites.append((node.name, "fused_block_int8", op))
        run = self._run["fused_block_int8"]
        xname, final, og = info["x"], info["final"], info["out_grid"]
        skip = list(info["skip"]) + [final]

        def block(env, done):
            v = env[xname]
            _, H, W, _ = v.q.shape
            if not kernels.fused_block_fits(H, W, C, E, C2):
                return unfused(env, done)
            out = run(v.q, op)
            env[final] = out if og is None else QTensor(out, og[0], og[1])
            done.update(skip)

        return block

    def _build_act(self, node) -> Step:
        name, src = node.name, node.inputs[0]
        g = self._grids[src]
        sp = self.plan.get(name)
        if g is None:
            self._grids[name] = sp

            def act_f32(env, done):
                v = env[src]
                self._emit(env, name, torch.relu(v) if node.op == "relu"
                           else torch.clamp(v, 0.0, 6.0))

            return act_f32
        self._grids[name] = sp if (sp is not None and sp != g) else g
        # exact: clamp at the zero point (and at quant(6), host f64) in the
        # int domain
        lo = g[1]
        hi = 127 if node.op == "relu" else int(np.clip(np.round(6.0 / g[0]) + g[1], -128, 127))

        def act_i8(env, done):
            v = env[src]
            t = QTensor(torch.clamp(v.q, lo, hi), v.scale, v.zp)
            if sp is not None and sp != (v.scale, v.zp):
                t = QTensor(_requant_i8(t, sp[0], sp[1]), sp[0], sp[1])
            env[name] = t

        return act_i8

    def _build_add(self, node) -> Step:
        name = node.name
        self._grids[name] = self.plan.get(name)
        sps = [_site_params(self.model, f"{name}:in{i}") for i in (0, 1)]

        def operand(env, i):
            v = env[node.inputs[i]]
            sp = sps[i]
            if isinstance(v, QTensor) and sp:
                # dequantize through the site grid: q * s - zp * s, one FMA
                q = _requant_i8(v, sp[0], sp[1]).to(torch.float32)
                return fma_f32(q, f32(sp[0]), -f32(sp[1] * sp[0]))
            return v.dequant() if isinstance(v, QTensor) else v

        def add(env, done):
            self._emit(env, name, operand(env, 0) + operand(env, 1))

        return add

    def _build_mean(self, node) -> Step:
        """Spatial mean in f32 (the JAX engine's fallback), in the order
        and with the constant folding XLA:CPU gives it: the site
        quantize's multiply folds into the dequant's, the sum runs
        sequentially over (h, w), and ``/ n`` folds into the output
        quantize's reciprocal."""
        name, src = node.name, node.inputs[0]
        site = _site_params(self.model, f"{name}:in0")
        sp = self.plan.get(name)
        self._grids[name] = sp

        def mean(env, done):
            v = env[src]
            if isinstance(v, QTensor):
                dq = v.q.to(torch.float32) - v.zp
                if site is None:
                    x = dq * f32(v.scale)
                else:
                    # ((q - zp) * s) * f32(1/s_site) -> (q - zp) * f32(s * r)
                    c = f32(np.float32(v.scale) * np.float32(recip_xla(site[0])))
                    qs = quant_u8(dq * c, 1.0, site[1]).to(torch.float32)
                    x = (qs - site[1]) * f32(site[0])
            else:
                x = v if site is None else (
                    _quantize_f32(v, *site).to(torch.float32) - site[1]) * f32(site[0])
            _, H, W, _ = x.shape
            acc = x[:, 0, 0]
            for i in range(1, H * W):
                acc = acc + x[:, i // W, i % W]
            if sp is None:
                env[name] = acc * f32(np.float32(1) / np.float32(H * W))
            else:
                q = quant_u8(acc, mean_quant_recip(H * W, sp[0]), sp[1])
                env[name] = QTensor(q, sp[0], sp[1])

        return mean

    def _site(self, name: str, kernel: str, op) -> None:
        if name not in self._fused_away:
            self.kernel_sites.append((name, kernel, op))

    # -- runtime helpers ----------------------------------------------------
    def _getter(self, src: str, grid: Grid) -> Callable[[Dict[str, Any]], torch.Tensor]:
        def get_i8(env):
            v = env[src]
            if isinstance(v, QTensor):
                return _requant_i8(v, grid[0], grid[1])
            return _quantize_f32(v, grid[0], grid[1])

        return get_i8

    def _store(self, env, name, q, sp) -> None:
        env[name] = q if sp is None else QTensor(q, sp[0], sp[1])

    def _emit(self, env, name, out_f32) -> None:
        """Store a node output, quantizing per the consumer plan."""
        sp = self.plan.get(name)
        if sp is None:
            env[name] = out_f32
        else:
            env[name] = QTensor(_quantize_f32(out_f32, sp[0], sp[1]), sp[0], sp[1])

    def forward(self, x: torch.Tensor):
        """``x``: f32 NHWC images on the module's device -> f32 logits."""
        env: Dict[str, Any] = {self.input_name: x}
        done: set = set()
        for name, step in self._steps:
            if name not in done:
                step(env, done)
        outs = []
        for o in self.outputs:
            v = env[o]
            outs.append(v.dequant() if isinstance(v, QTensor) else v)
        return outs[0] if len(outs) == 1 else tuple(outs)
