"""Fused int8-to-int8 execution on the hand-written kernels (port of
``dfq_tpu/engine/int8_fused.py``).

Each conv's requantization to its consumer's input grid is fused into the
conv epilogue, so inter-layer tensors stay int8. Under the default options
(``use_kernels=True, fuse_blocks=True``, the JAX engine's ``use_pallas=True,
fuse_blocks=True``):

- pointwise convs and linear layers run on K1 (``matmul_int8_requant``),
  depthwise 3x3 convs of stride 1 (pad 1) on K2 (``dw3x3_int8_requant``),
  and each inverted-residual chain ``pw-expand -> relu(6) -> dw3x3 s1 ->
  relu(6) -> pw-project [-> add]`` whose site grids line up on K3
  (``fused_block_int8``) — the three kernels of
  ``dfq_tpu_torch/ops/cuda_int8.py``;
- depthwise 3x3 convs of stride 2 (pad 1) with an int8 output run on K2's
  stride-2 variant, which rounds as the glue below does: the JAX engine
  runs them as XLA convs, and the port's outputs are its bit for bit;
- other lowered convs (MobileNetV2's k3s2 stem, ResNet-18's stem, 3x3 and
  downsample convs, DeepLab's explicitly padded depthwise convs) run as
  exact integer convs (:func:`~dfq_tpu_torch.engine.int8.int8_conv`) and
  the same epilogue in one CUDA pass over their accumulator
  (:mod:`~dfq_tpu_torch.ops.conv_epilogue`; under ``use_kernels`` and on
  CUDA, else its plain PyTorch version);
- ReLU is a clamp at the zero point and ReLU6 a clamp at quant(6), both in
  the int domain; residual adds dequantize both operands through their
  site grids and requantize; folded BN/identity pass int8 through;
- the spatial mean runs in f32, as in the JAX engine's fallback;
- max pooling and padding stay in the int8 domain (max commutes with the
  monotone grid; real 0 is the zero point), a concat of int8 inputs
  requantizes each branch onto its site grid and then onto the
  consumer's, and every other op (non-lowered conv/linear, concat,
  pools, pad, resize, softmax, reshape, l2norm, permute) runs in f32 on
  dequantized inputs with the engine's site fake-quant, as the JAX
  engine's generic fallback.

The JAX engine's lowering policies are options of :class:`Int8FusedNet`
and :func:`execute_int8_fused`, with its names and routing order; each is
an exact rewrite of the convs no kernel takes, so none changes an output:
``stem_s2d`` (space-to-depth stem), ``dw_dense_max_ch`` /
``dw_dense_max_h`` (depthwise as a dense-diagonal conv), ``chpad_k3``
(zero-weight channel padding), ``k3_matmul`` (dense 3x3 convs as shift9
or im2col GEMMs), ``b2s_min_h`` (batch-to-space fold), and ``auto_config``
for the ``"auto"`` values. Their defaults here keep the forward that the
card runs without them (see :func:`auto_config`); they were tuned on the
TPU and none has been chosen by a measurement on this card yet. The two
kernel options, ``use_kernels`` and ``fuse_blocks``, choose which code
rounds each requantization, and the JAX engine's kernels round a tie of
the output scale's reciprocal in two ways (K1 and K2 multiply by
``f32(1.0 / s)``, K3 and the glue by ``f32(1 / f32(s))``): like the JAX
engine's, their outputs can differ from the default's by a grid step
where a value lands on such a tie, and equal the JAX engine's under the
same options bit for bit.

``profile_barriers`` has no counterpart: it stops XLA fusing depthwise
convs into their neighbours for a trace, and eager PyTorch fuses nothing.
While a ``torch.profiler`` runs, and only then, the forward opens one
range per step, ``int8_fused/<kind>:<node>`` (kinds: :data:`STEP_KINDS`),
and inside the steps the phase ranges ``int8_fused/product`` (a conv's
exact int8 product, on whichever route), ``int8_fused/requant`` (an input
edge's requantization) and ``int8_fused/epilogue`` (every other int/float
conversion of the glue); ``python3 -m portbench.spans`` sums device time
and idle by them. The ranges are FUNCTION-scope profiler ranges, so each
device op is tied to them through its launch's correlation and none takes
a device annotation from a caller's ``record_function``. Always on:
:attr:`Int8FusedNet.host`, the forward's calls and host seconds,
:data:`FALLBACK_BYTES`, the bytes an image of each f32 fallback step, and
:data:`GRAPH_COUNTS`, the forwards by how they ran.

On CUDA the forward replays a CUDA graph once it has seen an input key
twice (:func:`graph_key`: the input's shape, strides, dtype and device,
and the resolved policy). The first forward at a key runs step by step;
the second captures the steps up to the first that writes a net output
(:attr:`Lowering.cut`), the prefix, into a graph on a side stream, and it
and every later forward at the key copy the input into the graph's
static input, replay it, and run the suffix (MobileNetV2's classifier,
SSD-Lite's box concat and class softmax, DeepLab's final resize) step by
step on the boundary values the net keeps, so each call returns tensors
of its own. A net's graphs share one memory pool and replay one at a
time: a lock holds from the input copy until the suffix is issued, and
the caller's stream waits for the previous replay's suffix. A CPU net,
``plain_kernels=True`` and a call while the current stream is capturing
run step by step. The kernels' launch counters count their wrappers'
calls, which a replay does not make: a replayed forward adds only its
suffix's, and the capturing forward its prefix's twice (the run before
the capture and the capture) and its suffix's. A trace shows the kernels
a replay runs, one a site of the lowering. While a profiler runs, a
replay opens one range, ``int8_fused/graph``, and only the suffix's steps
open theirs.

The int8 tensor carried on an edge uses the CONSUMER's site quantization
params (:func:`_consumer_plan`). The f32 glue mirrors the forms XLA
compiles the JAX engine into (``dfq_tpu_torch/ops/rounding.py``), so the
port's logits match the JAX engine's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch._C._profiler import _RecordFunctionFast as _Range
from torch.autograd import profiler as _autograd_profiler

from dfq_tpu_torch.device import resolve_device
from dfq_tpu_torch.engine.int8 import (
    Int8Model,
    b2s_applicable,
    int8_conv,
    int8_conv_b2s,
    int8_conv_im2col,
    int8_conv_shift9,
    int8_linear,
    pack_int8_product,
)
from dfq_tpu_torch.graph.executor import apply_op, highest_precision, params_to
from dfq_tpu_torch.graph.ir import Graph
from dfq_tpu_torch.ops import conv_epilogue
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

# the kind of each step, fixed when the lowering is built: a kernel (K1,
# K2, K3), an exact int8 product off the kernels ("conv", on any of
# ``_route``'s routes), or the glue op the node is
STEP_KINDS = ("k1", "k2", "k3", "conv", "act", "add", "mean", "spatial", "concat",
              "fallback", "passthrough")
PRODUCT, REQUANT, EPILOGUE = "int8_fused/product", "int8_fused/requant", "int8_fused/epilogue"
GRAPH = "int8_fused/graph"
_NO_RANGE = contextlib.nullcontext()

# node -> (op, bytes an image of its f32 output) of every f32 fallback
# step, as the last forward that ran it wrote them: read from shapes on
# the host, with no sync; one plain dict store a step
FALLBACK_BYTES: Dict[str, Tuple[str, int]] = {}

# the forwards of every net by how they ran: "eager" step by step,
# "replays" from a CUDA graph (the capturing forward too); "captures" the
# graphs captured. One plain dict add a forward, no sync
GRAPH_COUNTS: Dict[str, int] = {"captures": 0, "replays": 0, "eager": 0}

# ops whose output may be their input or a view of it: a net output made
# by one is handed out from its producer's memory
_VIEW_OPS = {"bn", "identity", "dropout", "reshape", "permute_nchw"}


def _phase(spans: bool, name: str):
    """A phase range while the forward is traced (``spans``), else nothing."""
    return _Range(name) if spans else _NO_RANGE


class HostTime:
    """Calls of a function and the host seconds they took, from entry to
    return, summed under a lock (serving threads share a net)."""

    def __init__(self):
        self.calls = 0
        self.seconds = 0.0
        self._lock = threading.Lock()

    def add(self, seconds: float) -> None:
        with self._lock:
            self.calls += 1
            self.seconds += seconds


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


class ConcatTable:
    """An int8 concat whose branches map their codes, in one gather.

    ``fns[i]`` maps branch ``i``'s int8 codes (None keeps them). The maps
    are tabled on ``device`` once, for every pair of codes and for every
    code, so a table entry is the map's own output there, bit for bit. A
    call reads each branch as rows of its codes from ``axis`` on, builds
    the output's table indices branch by branch (pairs of codes where
    every branch's rows hold an even count at an even offset, else single
    codes) and gathers the output in one pass, whichever branches map
    their codes."""

    def __init__(self, fns: Sequence[Optional[Callable[[torch.Tensor], torch.Tensor]]], device):
        self.device = device
        pairs = torch.arange(2**16, dtype=torch.int32, device=device).to(torch.int16).view(torch.int8)
        codes = torch.arange(-128, 128, dtype=torch.int32, device=device).to(torch.int8)
        # branch i's entry for the int16 word w at 2**16 * i + 2**15 + w, and
        # for the code c at 256 * i + 128 + c
        self.pairs = torch.cat([torch.roll((pairs if f is None else f(pairs)).view(torch.int16), 2**15)
                                for f in fns])
        self.singles = torch.cat([codes if f is None else f(codes) for f in fns])
        self._bases: Dict[Tuple[int, int, int], torch.Tensor] = {}

    def _base(self, i: int, width: int, n: int) -> torch.Tensor:
        key = (i, width, n)
        if key not in self._bases:
            base = 2**16 * i + 2**15 if width == 2 else 256 * i + 128
            self._bases[key] = torch.full((n,), base, dtype=torch.int32, device=self.device)
        return self._bases[key]

    def __call__(self, qs: Sequence[torch.Tensor], axis: int) -> torch.Tensor:
        axis %= qs[0].dim()
        outer = int(np.prod(qs[0].shape[:axis]))
        rows = [q.reshape(outer, -1).contiguous() for q in qs]
        width = 2 if all(r.shape[1] % 2 == 0 and r.storage_offset() % 2 == 0 for r in rows) else 1
        table, dtype = (self.pairs, torch.int16) if width == 2 else (self.singles, torch.int8)
        idx = torch.empty(outer, sum(r.shape[1] for r in rows) // width, dtype=torch.int32,
                          device=self.device)
        col = 0
        for i, r in enumerate(rows):
            n = r.shape[1] // width
            torch.add(r.view(dtype), self._base(i, width, n), out=idx[:, col:col + n])
            col += n
        shape = list(qs[0].shape)
        shape[axis] = sum(q.shape[axis] for q in qs)
        return table.index_select(0, idx.view(-1)).view(torch.int8).view(shape)


def _s2d_weights(qw: np.ndarray) -> np.ndarray:
    """Rewrite an odd-k, stride-2, pad-(k//2) stem conv's OIHW int8
    weights into the exact space-to-depth(2) equivalent: a
    ceil(k/2)-kernel stride-1 conv over 4x the channels. Tap (di, dj)
    maps to kernel position (di//2, dj//2) and packed channel
    ((di%2)*2 + dj%2)*C + c; unused positions are zero (so wsum is
    unchanged)."""
    o, c, kh, kw = qw.shape
    k2h, k2w = (kh + 1) // 2, (kw + 1) // 2
    w2 = np.zeros((o, 4 * c, k2h, k2w), np.int8)
    for di in range(kh):
        for dj in range(kw):
            ki, pi = di // 2, di % 2
            kj, pj = dj // 2, dj % 2
            w2[:, (pi * 2 + pj) * c: (pi * 2 + pj) * c + c, ki, kj] = qw[:, :, di, dj]
    return w2


def _space_to_depth2(xq: torch.Tensor, zp: int, pad: int = 1) -> torch.Tensor:
    """Pad by ``pad`` with zp then pack 2x2 pixel patches into channels:
    [N, H, W, C] -> [N, (H+2p)/2, (W+2p)/2, 4C]. Requires H+2p even."""
    n, h, w, c = xq.shape
    xp = F.pad(xq, (0, 0, pad, pad, pad, pad), value=zp)
    hp, wp = h + 2 * pad, w + 2 * pad
    y = xp.reshape(n, hp // 2, 2, wp // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(n, hp // 2, wp // 2, 4 * c)


def _dense_diag_weights(qw: np.ndarray) -> np.ndarray:
    """Depthwise OIHW [C,1,kh,kw] int8 -> dense [C,C,kh,kw] with the taps
    on the diagonal: dw(x, w) == conv(x, W), exactly (same int8 taps,
    zeros elsewhere; wsum unchanged), at C x the MACs."""
    c, _, kh, kw = qw.shape
    w = np.zeros((c, c, kh, kw), np.int8)
    w[np.arange(c), np.arange(c)] = qw[:, 0]
    return w


def _chpad_target(cin: int, kernel, groups: int) -> int:
    """Channel-pad target of a dense conv, or 0: 4 for the 3-channel
    stems (any kernel size); for a 3x3 conv with Cin above 128 and not a
    multiple of 128, the next multiple of 128 while that costs at most
    1.35x the MACs. Zero weight rows make the padding exact. The JAX
    engine's rule, tuned on the TPU (its lanes are 128 wide)."""
    if groups != 1:
        return 0
    if cin < 4:
        return 4
    if tuple(kernel) != (3, 3):
        return 0
    if cin <= 128 or cin % 128 == 0:
        return 0
    t = ((cin + 127) // 128) * 128
    return t if t <= cin * 1.35 else 0


def auto_config(batch_per_device: int) -> Tuple[int, bool]:
    """The batch-dependent policy ``(dw_dense_max_ch, stem_s2d)`` that
    ``"auto"`` resolves to, on this card: ``(0, False)`` at every batch.

    The JAX engine's rule (dense-diagonal depthwise up to 32 channels at
    per-device batch <= 8, the s2d stem from batch 64) was measured on the
    TPU, where XLA's grouped-conv configs collapse at small batch. No
    measurement on the H100 has chosen a policy yet, so ``"auto"`` keeps
    the forward the card runs without the rewrites; a benchmark cell that
    can judge one is what would change this. ``batch_per_device`` is the
    batch one device runs (a sharded caller's global batch / shards)."""
    del batch_per_device
    return 0, False


K3_MATMUL = ("off", "auto", "shift9", "im2col")


@dataclasses.dataclass(frozen=True)
class Policy:
    """The batch-dependent options, resolved: one set of packed steps
    each (:meth:`Int8FusedNet.plan`)."""

    dw_dense_max_ch: int
    stem_s2d: bool
    dw_dense_max_h: int


def resolve_policy(batch: int, stem_s2d="auto", dw_dense_max_ch="auto",
                   dw_dense_max_h="auto") -> Policy:
    """``"auto"`` against the per-device ``batch``, as the JAX engine
    resolves it (``int8_fused.py:362-379``): ``dw_dense_max_ch`` and
    ``stem_s2d`` from :func:`auto_config`, ``dw_dense_max_h`` 160 at batch
    1 and 128 above (the TPU's measured gate, kept as the JAX engine's).
    With dense-diagonal depthwise off, the height gate reads 0."""
    auto_dw, auto_stem = auto_config(batch)
    ch = auto_dw if dw_dense_max_ch == "auto" else int(dw_dense_max_ch)
    stem = auto_stem if stem_s2d == "auto" else bool(stem_s2d)
    h = (160 if batch <= 1 else 128) if dw_dense_max_h == "auto" else int(dw_dense_max_h)
    return Policy(ch, stem, h if ch else 0)


# ops through which an output grid propagates backward unchanged
_GRID_PASSTHROUGH = {"relu", "relu6", "bn", "identity", "dropout", "maxpool"}
# one-input ops the f32 fallback fake-quantizes at input 0 (concat: all)
_FALLBACK_SITE_OPS = {"conv", "linear", "global_mean", "interpolate", "softmax", "l2norm"}


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


def _lane_tree(t: torch.Tensor) -> torch.Tensor:
    """Sum over dim 1 (the vector lanes) as LLVM reduces a ``reassoc``
    vector: lane ``i`` with lane ``i + L/2``, halving."""
    while t.shape[1] > 1:
        half = t.shape[1] // 2
        t = t[:, :half] + t[:, half:]
    return t[:, 0]


def xla_cpu_mean_sum(x: torch.Tensor, fused_producer: bool) -> torch.Tensor:
    """Sum over (h, w) of NHWC f32 in XLA:CPU's order for the JAX fused
    engine's spatial mean (read from its LLVM IR, jax 0.9; the reduction's
    add is ``reassoc``, so LLVM vectorizes it):

    - at map width 4, 8 or 16 where the mean's loop also computes a fused
      producer (the residual add: ResNet-18), or at 16 after a kernel
      (MobileNetV2): a loop over rows carries one sum; each row is a
      vector of 8 lanes (4 at width 4), lane 0 starting from the carried
      sum, the second half of a 16-wide row added lane by lane onto the
      first, and the lanes reduced as a halving tree;
    - at height 4 or 8 after a kernel: each row is a lane summed in order
      over the width, the rows reduced as a halving tree;
    - otherwise in order over (h, w)."""
    _, H, W, _ = x.shape
    if W in (4, 8, 16) and (fused_producer or W == 16):
        vf = min(W, 8)
        acc = torch.zeros_like(x[:, 0, 0])
        for h in range(H):
            lanes = x[:, h, W - vf:].clone()
            lanes[:, 0] = acc + lanes[:, 0]
            if W > vf:
                lanes = x[:, h, :vf] + lanes
            acc = _lane_tree(lanes)
        return acc
    if H in (4, 8) and not fused_producer:
        lanes = x[:, :, 0]
        for w in range(1, W):
            lanes = lanes + x[:, :, w]
        return _lane_tree(lanes)
    acc = x[:, 0, 0]
    for i in range(1, H * W):
        acc = acc + x[:, i // W, i % W]
    return acc


def _blocks_that_run(graph: Graph, blocks):
    """The blocks of ``blocks`` a forward runs. A forward walks the graph in
    order and skips what an earlier block fused away, so where chains
    overlap (MobileNetV1's pw -> dw -> pw -> dw -> pw: a block's project is
    the next block's expand) the later block never runs and its depthwise
    conv runs alone, in both engines (``int8_fused.py:419-420``)."""
    done: set = set()
    kept = {}
    for node in graph:
        info = blocks.get(node.name)
        if info is None or node.name in done:
            continue
        kept[node.name] = info
        done.update(info["skip"])
        done.add(info["final"])
    return kept


def _is_pw(node) -> bool:
    a = node.attrs
    return (node.op == "conv" and a["kernel"] == (1, 1) and a["groups"] == 1
            and a["stride"] == (1, 1) and a["padding"] == (0, 0))


def _is_dw1(node) -> bool:
    a = node.attrs
    return (node.op == "conv" and a["kernel"] == (3, 3) and a["groups"] == a["in_ch"]
            and a["stride"] == (1, 1) and a["padding"] == (1, 1)
            and a["dilation"] == (1, 1))


def _is_dw2(node) -> bool:
    a = node.attrs
    return (node.op == "conv" and a["kernel"] == (3, 3)
            and a["groups"] == a["in_ch"] == a["out_ch"]
            and a["stride"] == (2, 2) and a["padding"] == (1, 1)
            and a["dilation"] == (1, 1))


# ``step(env, done, spans)``: ``spans`` opens the step's phase ranges
Step = Callable[[Dict[str, Any], set, bool], None]
Acc = Callable[[torch.Tensor], torch.Tensor]  # int8 NHWC input -> accumulator (_route)


@dataclasses.dataclass
class Lowering:
    """The packed forward of one resolved :class:`Policy`: the steps as
    ``(node, kind, step)`` (kind: one of :data:`STEP_KINDS`), the kernel
    sites they launch, the exact int8 products of the other lowered
    layers, and the glue ``conv`` steps as ``(node, product, epilogue)``:
    the route (``xq -> acc``) and the packed
    :class:`~dfq_tpu_torch.ops.conv_epilogue.ConvEpilogue` of each.

    ``steps[:cut]`` is the prefix a CUDA graph holds, ``steps[cut:]`` the
    suffix run after its replay: from the first step that writes a net
    output, or the step whose value such an output passes on or views.
    ``suffix_reads`` names the values the suffix may read."""

    policy: Policy
    steps: List[Tuple[str, str, Step]]
    kernel_sites: List[Tuple[str, str, Any]]
    products: Dict[str, Any]
    epilogue_sites: List[Tuple[str, Acc, Any]] = dataclasses.field(default_factory=list)
    cut: int = 0
    suffix_reads: frozenset = frozenset()


def graph_key(x: torch.Tensor, policy: Policy) -> Tuple:
    """What a forward's CUDA graph is captured for: the input's shape,
    strides, dtype and device, and the resolved policy."""
    return tuple(x.shape), x.stride(), x.dtype, x.device, policy


@dataclasses.dataclass
class Captured:
    """One key's graph of a lowering's prefix: ``graph.replay()`` runs it
    on ``x``, its static input; ``env`` holds the prefix's values that the
    suffix reads, ``done`` the nodes the prefix fused away."""

    graph: Any
    x: torch.Tensor
    env: Dict[str, Any]
    done: frozenset


class Int8FusedNet(nn.Module):
    """The fused int8 network of an :class:`Int8Model`, on one device.

    Every layer's device operands (transposed or word-packed weights,
    ``wsum``, combined scales, bias, depthwise taps) are packed once here;
    :meth:`forward` then copies nothing to the device but its input.
    ``device=None`` means CUDA, and raises without it; ``device="cpu"``
    runs the kernels' plain versions. ``plain_kernels=True`` runs the
    plain versions on any device, to hold the CUDA kernels against them
    on the card.

    ``params_f32`` supplies the f32 params of the layers that were not
    lowered (and of ``l2norm``), as the JAX engine's ``params_f32``.

    The keyword options are the JAX engine's, with its meanings and its
    routing order for a lowered layer (``int8_fused.py:415-671``): a
    fusable block on K3 (``fuse_blocks``; K3 launches whether or not
    ``use_kernels`` is set, as the JAX engine's blocks run on their kernel
    whatever ``use_pallas`` says); then the s2d stem (``stem_s2d``: a
    k3s2p1 conv on the graph input, even input height); then the kernel
    sites (``use_kernels``, JAX's ``use_pallas``: pointwise convs and
    linear layers on K1, depthwise 3x3 of stride 1 on K2, and of stride 2
    with an int8 output on K2's stride-2 variant, where the JAX engine's
    XLA conv stands and which gives its outputs); then, for a
    depthwise conv of at most ``dw_dense_max_ch`` channels on a map at
    most ``dw_dense_max_h`` high, the dense-diagonal conv; then channel
    padding (``chpad_k3``, :func:`_chpad_target`); then a dense 3x3 conv as
    GEMMs (``k3_matmul``: ``"shift9"`` or ``"im2col"`` for every such
    conv with ``in_ch >= k3_matmul_min_ch``; ``"auto"`` shift9 for the
    dilated ones with ``in_ch >= 256``, where ``in_ch`` is read after
    channel padding, as the JAX engine reads it, so a dilated conv of 200
    channels padded to 256 qualifies; ``"off"``); then the batch-to-space
    fold (``b2s_min_h``: input height at least this, batch above 1,
    :func:`~dfq_tpu_torch.engine.int8.b2s_applicable`; 0 disables); then
    :func:`~dfq_tpu_torch.engine.int8.int8_conv`. Linear layers off the
    kernels are one exact int8 GEMM. Every route is exact, so the conv
    policies give the default's outputs bit for bit; ``use_kernels`` and
    ``fuse_blocks`` move requantizations between kernels whose reciprocal
    forms differ (module docstring), as in the JAX engine.

    Defaults, and where they differ from the JAX engine's: ``use_kernels``
    and ``fuse_blocks`` on (JAX: off); ``stem_s2d``, ``dw_dense_max_ch``
    and ``dw_dense_max_h`` ``"auto"`` (resolved by this card's
    :func:`auto_config`); ``k3_matmul="auto"``, JAX's rule, whose shift9
    form is :func:`int8_conv`'s own route on CUDA; ``chpad_k3`` off (JAX:
    on; its 128-lane rule is the TPU's and is not measured here);
    ``b2s_min_h=0``. ``"auto"`` resolves against ``per_device_batch``, or
    the forward's batch where it is None; each resolved :class:`Policy`
    packs its steps once (:meth:`lowering`), and the operands that two
    policies share are packed once.

    ``kernel_sites`` lists ``(node, kernel name, packed operands)`` of
    every kernel launch the last forward's policy makes when every
    fusable block fits (before the first forward: the policy at
    ``per_device_batch``, or at a batch above 1); ``products`` the packed
    exact int8 product of every other lowered layer, of the route its
    static options pick (a dense-diagonal or s2d conv falls back to its
    plain product where the map's height fails the gate, as in the JAX
    engine). ``host`` (:class:`HostTime`) sums the forwards and their host
    seconds: step by step, or the input copy, the replay and the suffix
    (module docstring). Only a capture syncs with the device, so where a
    forward's input's device work is done when it is called, that is the
    host time spent issuing it.
    """

    def __init__(self, model: Int8Model, device=None, plain_kernels: bool = False,
                 params_f32: Optional[Dict[str, Dict[str, Any]]] = None, *,
                 use_kernels: bool = True, fuse_blocks: bool = True, stem_s2d="auto",
                 dw_dense_max_ch="auto", dw_dense_max_h="auto", b2s_min_h: int = 0,
                 k3_matmul: str = "auto", k3_matmul_min_ch: int = 0, chpad_k3: bool = False,
                 per_device_batch: Optional[int] = None):
        super().__init__()
        if model.bits_act != 8:
            raise ValueError(
                "fused int8 engine requires bits_act=8; "
                f"A{model.bits_act} regimes are not ported"
            )
        if k3_matmul not in K3_MATMUL:
            raise ValueError(f"k3_matmul={k3_matmul!r}; expected one of {K3_MATMUL}")
        self.device = resolve_device(device)
        self.model = model
        self.params = params_to(params_f32 or {}, self.device)
        self.use_kernels = use_kernels
        self.plain_kernels = plain_kernels
        self.options = dict(stem_s2d=stem_s2d, dw_dense_max_ch=dw_dense_max_ch,
                            dw_dense_max_h=dw_dense_max_h)
        self.b2s_min_h = b2s_min_h
        self.k3_matmul = k3_matmul
        self.k3_matmul_min_ch = k3_matmul_min_ch
        self.chpad_k3 = chpad_k3
        self.per_device_batch = per_device_batch
        graph = model.graph
        self.plan = _consumer_plan(graph, model)
        self.blocks = (_blocks_that_run(graph, _find_fusable_blocks(graph, model, self.plan))
                       if fuse_blocks else {})
        self._fused_away = {n for b in self.blocks.values() for n in b["skip"]}
        self._fused_away.update(b["final"] for b in self.blocks.values())
        self._fused_away.update(self.blocks)
        # kernel name -> its wrapper (launch on CUDA, plain version on the
        # CPU), or its plain version on any device
        impl = "plain" if plain_kernels else "packed"
        self._run = {k: getattr(kernels, f"{k}_{impl}") for k in kernels.LAUNCHES}
        # the glue convs' epilogue: its kernel's wrapper under use_kernels
        self._epilogue = getattr(
            conv_epilogue, f"conv_epilogue_{impl if use_kernels else 'plain'}")
        self.input_name = graph.input_names()[0]
        self.outputs = graph.outputs
        self._packed: Dict[Tuple[str, str], Any] = {}
        self._lowerings: Dict[Policy, Lowering] = {}
        self.host = HostTime()
        # CUDA graphs by graph_key, the keys seen, and what replays share
        self._graphs: Dict[Tuple, Captured] = {}
        self._seen: set = set()
        self._graph_lock = threading.Lock()
        self._pool = self._capture_stream = self._suffix_done = None
        self._use(self.lowering(per_device_batch or 2))

    def policy(self, batch: int) -> Policy:
        """The options resolved for a forward at per-device ``batch``."""
        return resolve_policy(batch, **self.options)

    def lowering(self, batch: int) -> Lowering:
        """The packed forward at per-device ``batch``, built on first use."""
        pol = self.policy(batch)
        if pol not in self._lowerings:
            self._lowerings[pol] = self._build_lowering(pol)
        return self._lowerings[pol]

    def _use(self, low: Lowering) -> Lowering:
        self.kernel_sites, self.products = low.kernel_sites, low.products
        return low

    def _build_lowering(self, policy: Policy) -> Lowering:
        self._policy = policy
        self._low = Lowering(policy, [], [], {})
        # grid of every node's output as this engine produces it (None:
        # f32); fixed by the plan, so every decision below is static
        self._grids: Dict[str, Optional[Grid]] = {self.input_name: None}
        graph = self.model.graph
        for node in graph:
            if node.op != "input":
                self._low.steps.append((node.name, *self._build(node)))
        index = {name: i for i, (name, _, _) in enumerate(self._low.steps)}

        def made_at(name):
            while graph[name].op in _VIEW_OPS and graph[name].inputs[0] in index:
                name = graph[name].inputs[0]
            return index[name]

        low = self._low
        low.cut = min((made_at(o) for o in self.outputs if o in index),
                      default=len(low.steps))
        low.suffix_reads = frozenset(
            {i for name, _, _ in low.steps[low.cut:] for i in graph[name].inputs}
            | set(self.outputs))
        return low

    # -- packing ----------------------------------------------------------
    def _bias(self, layer) -> np.ndarray:
        if layer.bias is not None:
            return layer.bias
        return np.zeros(layer.qweight.shape[0], np.float32)

    def _pack(self, key: Tuple[str, str], make: Callable[[], Any]) -> Any:
        """Pack once per key, whichever policies share the operands."""
        if key not in self._packed:
            self._packed[key] = make()
        return self._packed[key]

    def _product(self, name: str, variant: str, qweight, node, form: str = "conv"):
        if form == "b2s" and self.device.type != "cpu":
            form = "conv"  # the same packing on CUDA
        return self._pack((name, f"{variant}/{form}"),
                          lambda: pack_int8_product(qweight, node, self.device, form))

    def _build(self, node) -> Tuple[str, Step]:
        """``(kind, step)`` of one node."""
        model, name, op = self.model, node.name, node.op
        grids = self._grids
        if op in ("conv", "linear") and name in model.layers:
            kind, step = self._build_layer(node)
            if name in self.blocks:
                kind, step = self._build_block(node, kind, step)
            grids[name] = self.plan.get(name)
            return kind, step
        if op in ("relu", "relu6"):
            return "act", self._build_act(node)
        if op == "add":
            return "add", self._build_add(node)
        if op in ("bn", "identity", "dropout"):
            src = node.inputs[0]
            grids[name] = grids[src]

            def passthrough(env, done, spans, name=name, src=src):
                env[name] = env[src]  # folded BN is identity

            return "passthrough", passthrough
        if op == "global_mean":
            return "mean", self._build_mean(node)
        if op in ("maxpool", "pad") and grids[node.inputs[0]] is not None:
            return "spatial", self._build_i8_spatial(node)
        if op == "concat" and self._concat_i8(node):
            return "concat", self._build_concat(node)
        return "fallback", self._build_fallback(node)

    def _build_layer(self, node) -> Tuple[str, Step]:
        name = node.name
        layer = self.model.layers[name]
        src = node.inputs[0]
        sp = self.plan.get(name)
        in_grid = (layer.in_scale, layer.in_zp)
        comb = np.asarray(layer.in_scale * layer.w_scale, np.float32)
        get = self._getter(src, in_grid)
        s_out, zp_out = sp if sp is not None else (1.0, 0)
        out_ch = layer.qweight.shape[0]
        is_stem = self._is_s2d_stem(node)
        if self.use_kernels and not is_stem and (node.op == "linear" or _is_pw(node)):
            op = self._pack((name, "k1"), lambda: kernels.pack_matmul(
                layer.qweight.reshape(out_ch, -1), comb, self._bias(layer), layer.wsum,
                zp_in=layer.in_zp, s_out=float(s_out), zp_out=int(zp_out),
                out_f32=sp is None, device=self.device))
            self._site(name, "matmul_int8_requant", op)
            run = self._run["matmul_int8_requant"]

            def pw(env, done, spans):
                with _phase(spans, REQUANT):
                    xq = get(env)
                q = run(xq.reshape(-1, xq.shape[-1]), op)
                self._store(env, name, q.reshape(xq.shape[:-1] + (out_ch,)), sp)

            return "k1", pw
        if self.use_kernels and not is_stem and (
                _is_dw1(node) or (_is_dw2(node) and sp is not None)):
            op = self._pack((name, "k2"), lambda: kernels.pack_dw3x3(
                layer.qweight[:, 0].reshape(out_ch, 9).T, comb, self._bias(layer),
                zp_in=layer.in_zp, s_out=float(s_out), zp_out=int(zp_out),
                out_f32=sp is None, stride=node.attrs["stride"][0], device=self.device))
            self._site(name, "dw3x3_int8_requant", op)
            run = self._run["dw3x3_int8_requant"]

            def dw(env, done, spans):
                with _phase(spans, REQUANT):
                    xq = get(env)
                self._store(env, name, run(xq, op), sp)

            return "k2", dw
        # any other layer: an exact integer product by the policy's route,
        # and the epilogue (ops/conv_epilogue.py) on its accumulator
        acc_of = self._route(node, layer, is_stem)
        ep = self._pack((name, "epilogue"), lambda: conv_epilogue.pack_conv_epilogue(
            layer.wsum, comb, layer.bias, zp=layer.in_zp, grid=sp, device=self.device))
        epilogue = self._epilogue
        if name not in self._fused_away:
            self._low.epilogue_sites.append((name, acc_of, ep))

        def conv(env, done, spans):
            with _phase(spans, REQUANT):
                xq = get(env)
            with _phase(spans, PRODUCT):
                acc = acc_of(xq)
            with _phase(spans, EPILOGUE):
                self._store(env, name, epilogue(acc, ep), sp)

        return "conv", conv

    def _is_s2d_stem(self, node) -> bool:
        """A k3s2p1 dense conv on the graph input, under ``stem_s2d`` (the
        input's height is checked at run time). Only k3 stems: the JAX
        engine never rewrites the k7 ResNet stem."""
        a = node.attrs
        return (self._policy.stem_s2d and node.op == "conv"
                and self.model.graph[node.inputs[0]].op == "input"
                and a["kernel"] == (3, 3) and a["stride"] == (2, 2)
                and a["padding"] == (1, 1) and a["groups"] == 1 and a["dilation"] == (1, 1))

    def _route(self, node, layer, is_stem: bool) -> Acc:
        """The exact int8 product of a lowered layer that no kernel takes,
        by the JAX engine's policy order, as ``xq -> acc`` (int32 NHWC, or
        a float route's raw NCHW output: :func:`int8_conv`'s ``raw``);
        records its product in ``products``."""
        name, zp, qw = node.name, layer.in_zp, layer.qweight
        products = self._low.products
        if node.op == "linear":
            prod = products[name] = self._product(name, "w", qw, node)
            return lambda xq: int8_linear(xq, prod)
        a = node.attrs
        if is_stem:
            # k3s2p1 over C channels == k2s1 VALID over 4C (s2d), exact
            node_s = node.replace(attrs={**a, "kernel": (2, 2), "stride": (1, 1),
                                         "padding": (0, 0), "in_ch": 4 * a["in_ch"]})
            prod_s = self._product(name, "s2d", _s2d_weights(qw), node_s)
            plain = self._route_dense(node, layer)

            def s2d(xq):
                if xq.shape[1] % 2:
                    return plain(xq)
                return int8_conv(_space_to_depth2(xq, zp, pad=1), node_s, prod_s, zp, raw=True)

            products[name] = prod_s
            return s2d
        pol = self._policy
        if (a["groups"] > 1 and a["groups"] == a["in_ch"] == qw.shape[0]
                and a["in_ch"] <= pol.dw_dense_max_ch):
            # depthwise as a dense conv with the taps on the diagonal
            node_d = node.replace(attrs={**a, "groups": 1})
            prod_d = self._product(name, "dense", _dense_diag_weights(qw), node_d)
            grouped = self._route_dense(node, layer)
            max_h = pol.dw_dense_max_h

            def dense(xq):
                if xq.shape[1] > max_h:
                    return grouped(xq)
                return int8_conv(xq, node_d, prod_d, zp, raw=True)

            products[name] = prod_d
            return dense
        return self._route_dense(node, layer)

    def _route_dense(self, node, layer) -> Acc:
        """chpad, then k3_matmul, then b2s, then :func:`int8_conv`."""
        name, zp, qw = node.name, layer.in_zp, layer.qweight
        a = node.attrs
        cin = a["in_ch"]
        cpad = _chpad_target(cin, a["kernel"], a["groups"]) if self.chpad_k3 else 0
        variant = "w"
        if cpad:
            # exact: the padded channels (zp) meet zero weight rows
            qw = np.concatenate(
                [qw, np.zeros((qw.shape[0], cpad - cin) + qw.shape[2:], np.int8)], axis=1)
            node = node.replace(attrs={**a, "in_ch": cpad})
            a, variant = node.attrs, f"chpad{cpad}"
        dil = tuple(a.get("dilation", (1, 1)))
        k3 = a["kernel"] == (3, 3) and a["groups"] == 1 and (
            (self.k3_matmul in ("shift9", "im2col") and a["in_ch"] >= self.k3_matmul_min_ch)
            or (self.k3_matmul == "auto" and dil != (1, 1) and a["in_ch"] >= 256))
        if k3:
            form = "im2col" if self.k3_matmul == "im2col" else "shift9"
            prod = self._product(name, variant, qw, node, form)
            fn = int8_conv_im2col if form == "im2col" else int8_conv_shift9

            def route(xq):
                return fn(xq, node, prod, zp)
        else:
            prod = self._product(name, variant, qw, node)
            min_h = self.b2s_min_h
            prod_b = self._product(name, variant, qw, node, "b2s") if min_h else None

            def route(xq):
                if (min_h and xq.shape[0] > 1 and xq.shape[1] >= min_h
                        and b2s_applicable(node, xq.shape[1])):
                    return int8_conv_b2s(xq, node, prod_b, zp)
                return int8_conv(xq, node, prod, zp, raw=True)

        self._low.products[name] = prod
        if not cpad:
            return route
        return lambda xq: route(F.pad(xq, (0, cpad - cin), value=zp))

    def _build_block(self, node, kind: str, unfused: Step) -> Tuple[str, Step]:
        """K3 for a fusable block when its input is int8 and the block fits
        the shared-memory budget at this input size; else the unfused
        layer-by-layer path (as ``int8_fused.py:431``), of ``kind``."""
        info = self.blocks[node.name]
        x_grid = self._grids.get(info["x"])
        if x_grid is None:
            return kind, unfused
        m = self.model
        Le, Ld, Lp = m.layers[node.name], m.layers[info["dw"]], m.layers[info["pj"]]
        E = Le.qweight.shape[0]
        C2 = Lp.qweight.shape[0]
        C = Le.qweight.shape[1]
        op = self._pack((node.name, "k3"), lambda: kernels.pack_fused_block(
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
        ))
        self._low.kernel_sites.append((node.name, "fused_block_int8", op))
        run = self._run["fused_block_int8"]
        xname, final, og = info["x"], info["final"], info["out_grid"]
        skip = list(info["skip"]) + [final]

        def block(env, done, spans):
            v = env[xname]
            _, H, W, _ = v.q.shape
            # v.q is a whole, contiguous tensor (16-byte aligned), for which
            # fused_block_fits answers
            if not kernels.fused_block_fits(H, W, C, E, C2):
                return unfused(env, done, spans)
            out = run(v.q, op)
            env[final] = out if og is None else QTensor(out, og[0], og[1])
            done.update(skip)

        return "k3", block

    def _build_act(self, node) -> Step:
        name, src = node.name, node.inputs[0]
        g = self._grids[src]
        sp = self.plan.get(name)
        if g is None:
            self._grids[name] = sp

            def act_f32(env, done, spans):
                v = env[src]
                out = torch.relu(v) if node.op == "relu" else torch.clamp(v, 0.0, 6.0)
                with _phase(spans, EPILOGUE):
                    self._emit(env, name, out)

            return act_f32
        self._grids[name] = sp if (sp is not None and sp != g) else g
        # exact: clamp at the zero point (and at quant(6), host f64) in the
        # int domain
        lo = g[1]
        hi = 127 if node.op == "relu" else int(np.clip(np.round(6.0 / g[0]) + g[1], -128, 127))

        def act_i8(env, done, spans):
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

        def add(env, done, spans):
            with _phase(spans, EPILOGUE):
                a, b = operand(env, 0), operand(env, 1)
            out = a + b
            with _phase(spans, EPILOGUE):
                self._emit(env, name, out)

        return add

    def _build_mean(self, node) -> Step:
        """Spatial mean in f32 (the JAX engine's fallback), in the order
        and with the constant folding XLA:CPU gives it: the site
        quantize's multiply folds into the dequant's, the sum runs in the
        order :func:`xla_cpu_mean_sum` mirrors, and ``/ n`` folds into the
        output quantize's reciprocal."""
        name, src = node.name, node.inputs[0]
        site = _site_params(self.model, f"{name}:in0")
        sp = self.plan.get(name)
        self._grids[name] = sp
        # the residual add (through its activation) fuses into the mean's
        # loop; a kernel's output does not
        prod = self.model.graph[src]
        while prod.op in ("relu", "relu6"):
            prod = self.model.graph[prod.inputs[0]]
        fused_producer = prod.op == "add"

        def mean(env, done, spans):
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
            acc = xla_cpu_mean_sum(x, fused_producer)
            if sp is None:
                env[name] = acc * f32(np.float32(1) / np.float32(H * W))
            else:
                q = quant_u8(acc, mean_quant_recip(H * W, sp[0]), sp[1])
                env[name] = QTensor(q, sp[0], sp[1])

        return mean

    def _build_i8_spatial(self, node) -> Step:
        """int8 max pooling (the int8 values pooled as f32 with -inf
        padding, exact, and cast back: ``F.max_pool2d`` takes no int8 on
        CUDA) and int8 padding with the zero point; the grid passes
        through."""
        name, src = node.name, node.inputs[0]
        self._grids[name] = self._grids[src]
        a = node.attrs

        def spatial_i8(env, done, spans):
            v = env[src]
            if node.op == "maxpool":
                q = F.max_pool2d(v.q.permute(0, 3, 1, 2).float(), a["window"], a["stride"],
                                 a["padding"]).to(torch.int8).permute(0, 2, 3, 1)
            else:
                t, b, l, r = a["pads"]
                q = F.pad(v.q, (0, 0, l, r, t, b), value=v.zp)
            env[name] = QTensor(q.contiguous(), v.scale, v.zp)

        return spatial_i8

    def _concat_i8(self, node) -> bool:
        return (all(self._grids[i] is not None for i in node.inputs)
                and self.plan.get(node.name) is not None
                and all(_site_params(self.model, f"{node.name}:in{i}") is not None
                        for i in range(len(node.inputs))))

    def _build_concat(self, node) -> Step:
        """int8 concat: each branch requantized onto its site grid, then
        onto the consumer's (the two roundings of the f32 path). Where
        any branch's grids are not both its own, the concat is one
        :class:`ConcatTable` gather, made here from the static grids: the
        ranges decide which branches need requantizing (DeepLab's decoder
        concat requantizes its 256 resized channels or its 48 low-level
        ones), and the step costs the same either way."""
        name = node.name
        sp = self.plan[name]
        self._grids[name] = sp
        sps = [_site_params(self.model, f"{name}:in{i}") for i in range(len(node.inputs))]
        axis = node.attrs.get("axis", -1)

        def both(grid, spi):
            def fn(q):
                q_site = QTensor(_requant_i8(QTensor(q, *grid), *spi), *spi)
                return _requant_i8(q_site, *sp)
            return fn

        fns = [None if self._grids[inp] == spi == sp else both(self._grids[inp], spi)
               for inp, spi in zip(node.inputs, sps)]
        table = (None if all(f is None for f in fns) else
                 self._pack((name, "concat"), lambda: ConcatTable(fns, self.device)))

        def concat_i8(env, done, spans):
            qs = [env[inp].q for inp in node.inputs]
            q = torch.cat(qs, dim=axis) if table is None else table(qs, axis)
            env[name] = QTensor(q, sp[0], sp[1])

        return concat_i8

    def _build_fallback(self, node) -> Step:
        """The JAX engine's generic f32 fallback: dequantized inputs, the
        engine's own site fake-quant (quantize, then ``(q - zp) * s``) at
        the inputs of conv/linear/concat/global_mean/interpolate/softmax/
        l2norm, the f32 op, and the output quantized per the plan."""
        name = node.name
        self._grids[name] = self.plan.get(name)
        p = self.params.get(name, {})
        if node.op in ("conv", "linear") and "weight" not in p:
            raise KeyError(f"Int8FusedNet: {name} is not lowered and params_f32 has no weight")
        n_site = (len(node.inputs) if node.op == "concat" else
                  1 if node.op in _FALLBACK_SITE_OPS else 0)
        sps = [_site_params(self.model, f"{name}:in{i}") for i in range(n_site)]

        def fallback(env, done, spans):
            ins = []
            for i, inp in enumerate(node.inputs):
                v = env[inp]
                v = v.dequant() if isinstance(v, QTensor) else v
                if i < n_site and sps[i] is not None:
                    s, zp = sps[i]
                    v = (_quantize_f32(v, s, zp).to(torch.float32) - zp) * f32(s)
                ins.append(v)
            out = apply_op(node, ins, p)
            FALLBACK_BYTES[name] = (node.op, out.numel() // out.shape[0] * out.element_size())
            with _phase(spans, EPILOGUE):
                self._emit(env, name, out)

        return fallback

    def _site(self, name: str, kernel: str, op) -> None:
        if name not in self._fused_away:
            self._low.kernel_sites.append((name, kernel, op))

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

    def forward(self, x: torch.Tensor, per_device_batch: Optional[int] = None):
        """``x``: f32 NHWC images on the module's device -> f32 logits.
        ``"auto"`` options resolve against ``per_device_batch``, else the
        module's, else ``x``'s batch. While a profiler runs, each step
        that runs opens its range (module docstring)."""
        t0 = time.perf_counter()
        low = self._use(self.lowering(per_device_batch or self.per_device_batch or x.shape[0]))
        g = None
        if self._graphable(x, low):
            key = graph_key(x, low.policy)
            with self._graph_lock:
                g = self._graphs.get(key)
                if g is None and key in self._seen:
                    g = self._graphs[key] = self._capture(low, x)
                    GRAPH_COUNTS["captures"] += 1
                self._seen.add(key)
                if g is not None:
                    out = self._replay(low, g, x)
        if g is None:
            GRAPH_COUNTS["eager"] += 1
            out = self._outputs(self._run_steps(low.steps, {self.input_name: x}, set()))
        self.host.add(time.perf_counter() - t0)
        return out

    def _graphable(self, x: torch.Tensor, low: Lowering) -> bool:
        """Whether a forward on ``x`` may capture or replay a CUDA graph."""
        return (x.device.type == "cuda" and not self.plain_kernels and low.cut > 0
                and not torch.cuda.is_current_stream_capturing())

    def _run_steps(self, steps, env: Dict[str, Any], done: set) -> Dict[str, Any]:
        """Run ``steps`` on ``env`` (node -> value), skipping what an earlier
        step fused away (``done``); returns ``env``."""
        # set while any torch profiler runs; _profiler_enabled() reads the
        # calling thread's state, which profile_all_threads leaves unset
        spans = _autograd_profiler._is_profiler_enabled
        with highest_precision():
            for name, kind, step in steps:
                if name in done:
                    continue
                if spans:
                    with _Range(f"int8_fused/{kind}:{name}"):
                        step(env, done, True)
                else:
                    step(env, done, False)
        return env

    def _outputs(self, env: Dict[str, Any]):
        outs = []
        for o in self.outputs:
            v = env[o]
            outs.append(v.dequant() if isinstance(v, QTensor) else v)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _capture(self, low: Lowering, x: torch.Tensor) -> Captured:
        """``low``'s prefix at ``x``'s key, captured into a CUDA graph on
        the net's side stream and memory pool (under ``_graph_lock``),
        after one run of it on that stream from this thread, which makes
        the thread's library handles and the stream's workspaces outside
        the capture."""
        dev = x.device
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
            self._capture_stream = torch.cuda.Stream(dev)
            self._suffix_done = torch.cuda.Event()
        side = self._capture_stream
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._run_steps(low.steps[:low.cut], {self.input_name: x}, set())
        torch.cuda.current_stream(dev).wait_stream(side)
        static = torch.empty_strided(x.shape, x.stride(), dtype=x.dtype, device=dev)
        graph = torch.cuda.CUDAGraph()
        done: set = set()
        with torch.cuda.device(dev), torch.cuda.graph(
                graph, pool=self._pool, stream=side, capture_error_mode="thread_local"):
            env = self._run_steps(low.steps[:low.cut], {self.input_name: static}, done)
        env = {k: env[k] for k in low.suffix_reads if k in env}
        return Captured(graph, static, env, frozenset(done))

    def _replay(self, low: Lowering, g: Captured, x: torch.Tensor):
        """One forward from ``g`` (under ``_graph_lock``): copy ``x`` in,
        replay, then run the suffix on the boundary values."""
        stream = torch.cuda.current_stream(x.device)
        stream.wait_event(self._suffix_done)
        with _phase(_autograd_profiler._is_profiler_enabled, GRAPH):
            g.x.copy_(x)
            g.graph.replay()
        env = dict(g.env)
        env[self.input_name] = x
        out = self._outputs(self._run_steps(low.steps[low.cut:], env, set(g.done)))
        self._suffix_done.record(stream)
        GRAPH_COUNTS["replays"] += 1
        return out


def execute_int8_fused(model: Int8Model, params_f32, x: torch.Tensor, device=None,
                       **options):
    """The JAX package's ``execute_int8_fused`` by name: builds an
    :class:`Int8FusedNet` with ``options`` (its keyword options:
    ``use_kernels``, the JAX engine's ``use_pallas``, ``fuse_blocks``,
    ``stem_s2d``, ``dw_dense_max_ch``, ``dw_dense_max_h``, ``b2s_min_h``,
    ``k3_matmul``, ``k3_matmul_min_ch``, ``chpad_k3``,
    ``per_device_batch``) and runs ``x`` through it. Build the module once
    to run many batches."""
    with torch.no_grad():
        return Int8FusedNet(model, device=device, params_f32=params_f32, **options)(x)
