"""The int8 kernels of the inference hot path, written by hand for Hopper.

Three CUDA kernels (sources in ``dfq_tpu_torch/csrc``) replace the three
Pallas TPU kernels of ``dfq_tpu/ops/pallas_int8.py``:

- :func:`matmul_int8_requant` (K1): pointwise convs and the classifier
  as an ``[M, K] x [K, N]`` int8 matmul with the requant epilogue fused.
- :func:`dw3x3_int8_requant` (K2): NHWC depthwise 3x3, stride 1; and, with
  no TPU kernel behind it, stride 2 (:func:`pack_dw3x3`).
- :func:`fused_block_int8` (K3): one whole inverted-residual block.

Each kernel has, in this module:

- a packed form of its operands (:class:`MatmulRequant`,
  :class:`Dw3x3Requant`, :class:`FusedBlock`), built once per call site on
  the device: weights pre-transposed or packed into 32-bit words, the
  epilogue constants rounded as the JAX reference rounds them
  (``dfq_tpu_torch/ops/rounding.py``);
- a wrapper (``*_packed``) that launches the kernel on a CUDA tensor and
  counts the launch in :data:`LAUNCHES`, raising if the build or the
  launch fails, and that runs the plain version for a CPU tensor (counted
  in :data:`PLAIN_CALLS`);
- its launch plan, made here in Python and handed to the kernel, where
  the CPU tests reach it: which variant a shape takes (K1: tensor-core
  ``mma`` or ``stream``, or ``dp4a``; K2: ``strip`` or ``general``, at stride 2
  ``strip_s2`` or ``general_s2``; K3: ``mma`` or
  ``general``; counted in :data:`VARIANTS`), tile and shared-memory
  layout, grid (:func:`matmul_plan`, :func:`dw3x3_plan`,
  :func:`fused_block_plan`);
- a plain PyTorch version (``*_plain``), device-agnostic and exact: int64
  or float64 integer math, then the same f32 epilogue forms. The CPU
  tests hold it bit-exact against the Pallas kernel in interpret mode,
  and ``chip_smoke.py`` holds the CUDA kernel against it on the card;
- a function with the JAX package's signature and layouts (``[K, N]``
  matmul weights, ``[9, C]`` taps) that packs and calls the wrapper.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from dfq_tpu_torch.device import resolve_device
from dfq_tpu_torch.ops import _build
from dfq_tpu_torch.ops.rounding import (
    f32,
    fma_f32,
    quant_u8,
    recip_host,
    recip_xla,
    requant_i8,
)

# launches of each CUDA kernel, and runs of its plain version through the
# wrapper; plain integers, reset with reset_counts(). Serving threads run
# forwards concurrently, so increments take the lock.
LAUNCHES = {"matmul_int8_requant": 0, "dw3x3_int8_requant": 0, "fused_block_int8": 0}
PLAIN_CALLS = dict.fromkeys(LAUNCHES, 0)
# launches by kernel variant, which a shape and its alignment alone decide
VARIANTS = {"matmul_int8_requant": {"mma": 0, "stream": 0, "dp4a": 0},
            "dw3x3_int8_requant": {"strip": 0, "general": 0, "strip_s2": 0, "general_s2": 0},
            "fused_block_int8": {"mma": 0, "general": 0}}
_count_lock = threading.Lock()

# the activation clamp of K1/K2 (pallas_int8.py:90-91)
_ACT = {"none": (-3.4e38, 3.4e38), "relu": (0.0, 3.4e38), "relu6": (0.0, 6.0)}

# the most dynamic shared memory one H100 thread block may use (227 KB),
# what one SM has for all its blocks (each block also costs 1 KB of it),
# and the SM count the plans assume when the caller names none
SMEM_BUDGET = 232448
SMEM_PER_SM = 233472
SMEM_PER_BLOCK_RESERVED = 1024
H100_SMS = 132


def reset_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            PLAIN_CALLS[k] = 0
        for by_variant in VARIANTS.values():
            for v in by_variant:
                by_variant[v] = 0


def _count(counts: dict, name: str) -> None:
    with _count_lock:
        counts[name] += 1


def _count_launch(name: str, variant: Optional[str] = None) -> None:
    with _count_lock:
        LAUNCHES[name] += 1
        if variant is not None:
            VARIANTS[name][variant] += 1


def _align16(v: int) -> int:
    return (v + 15) // 16 * 16


def _aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


_SMS: dict = {}


def _sm_count(device: torch.device) -> int:
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return n


def _route(x: torch.Tensor, name: str) -> bool:
    """True to launch the CUDA kernel, False to run the plain version:
    only a CPU tensor takes the plain version."""
    if x.device.type == "cpu":
        _count(PLAIN_CALLS, name)
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


def _check(name: str, t: torch.Tensor, dtype, shape: Tuple[int, ...], device) -> None:
    """The wrappers check each call's input with this, and the packed
    operands once, when they are built."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _stream(device: torch.device) -> int:
    """The current stream of ``device``, the input tensor's (not of the
    current device: a shard on ``cuda:1`` launches on ``cuda:1``)."""
    return torch.cuda.current_stream(device).cuda_stream


def _launch_on(device: torch.device):
    """The context a launch runs in: ``device`` current, since the ctypes
    call launches on the calling thread's current device."""
    return torch.cuda.device(device)


def _on(t, device, dtype) -> torch.Tensor:
    return torch.as_tensor(t).to(device=device, dtype=dtype).contiguous()


def _check_operands(name: str, device, *operands) -> None:
    """``operands``: (label, tensor, dtype, shape) of a packed call site."""
    for what, t, dtype, shape in operands:
        _check(f"{name} {what}", t, dtype, shape, device)


# ---------------------------------------------------------------------------
# K1: int8 matmul + requant

# the resident variant of csrc/matmul_int8_requant.cu: rows of x per
# tile (its TM), the widest column tile and deepest ring it takes, and the
# blocks per SM its __launch_bounds__ allow
MM_TILE_M = 128
MM_MAX_BN = 256
MM_MAX_STAGES = 8
MM_BLOCKS_PER_SM = 3
# bytes of x a block keeps in flight ahead of the tile it computes
MM_INFLIGHT = 16384
# the streamed variant: the widest column tile (its SNT n8 tiles of int32
# accumulators a warp), the blocks per SM its __launch_bounds__ allow, and
# its deepest ring of K slices
MM_STREAM_BN = 64
MM_STREAM_BLOCKS_PER_SM = 2
MM_STREAM_MAX_STAGES = 4
# the kernel's codes of the variants (MatmulArgs.variant)
MM_VARIANTS = ("dp4a", "mma", "stream")


@dataclasses.dataclass
class MatmulRequant:
    """Packed operands of one :func:`matmul_int8_requant` call site. N is
    padded to ``Np``, the next multiple of 8 (the tensor cores' column
    tiles), with zero weight rows and zero ``scale``, ``bias`` and
    ``wsum``, as the Pallas wrapper pads it; ``n_out`` is the real N."""

    w: torch.Tensor  # [Np, K] int8: the JAX [K, N] weight, transposed once
    scale: torch.Tensor  # [Np] f32: s_in * s_w
    bias: torch.Tensor  # [Np] f32
    wsum: torch.Tensor  # [Np] int32
    zp_in: int
    inv_out: float  # f32(1.0 / s_out), the Pallas kernel's reciprocal
    zp_out: int
    lo: float
    hi: float
    out_f32: bool
    n_out: int  # N: the columns of the output
    # launch arguments by (M, x is 16-byte aligned), all but the pointers x, out
    launch_args: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        Np, K = self.w.shape
        if Np % 8 or not Np - 8 < self.n_out <= Np:
            raise ValueError(f"matmul_int8_requant: {Np} weight rows do not pad "
                             f"N = {self.n_out} to a multiple of 8")
        _check_operands("matmul_int8_requant", self.w.device,
                        ("w", self.w, torch.int8, (Np, K)),
                        ("scale", self.scale, torch.float32, (Np,)),
                        ("bias", self.bias, torch.float32, (Np,)),
                        ("wsum", self.wsum, torch.int32, (Np,)))


def pack_matmul(w_nk, scale, bias, wsum, *, zp_in: int, s_out: float, zp_out: int,
                act: str = "none", out_f32: bool = False, device=None) -> MatmulRequant:
    """``w_nk``: ``[N, K]`` int8 (a pointwise conv's ``[O, I]`` weight).
    ``device=None`` means CUDA."""
    device = resolve_device(device)
    lo, hi = _ACT[act]
    w = _on(w_nk, device, torch.int8)
    N = w.shape[0]
    pad = -N % 8

    def padded(t, dtype):
        t = _on(t, device, dtype)
        return F.pad(t, (0, pad)) if pad else t

    return MatmulRequant(
        w=F.pad(w, (0, 0, 0, pad)) if pad else w,
        scale=padded(scale, torch.float32),
        bias=padded(bias, torch.float32),
        wsum=padded(wsum, torch.int32),
        zp_in=int(zp_in), inv_out=recip_host(s_out), zp_out=int(zp_out),
        lo=lo, hi=hi, out_f32=bool(out_f32), n_out=N,
    )


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """How one K1 call is launched. ``variant`` is ``"mma"`` (tensor cores,
    weights resident, a ring of whole-K x tiles), ``"stream"`` (tensor
    cores, x and w streamed in K slices, K split over warps and blocks
    where the tiles leave SMs idle) or ``"dp4a"`` (K not a multiple of 8,
    or an operand off its 16-byte boundary)."""

    variant: str
    bn: int = 0  # columns of the output per block
    stages: int = 0  # ring stages: x tiles (mma), K slices of x and w (stream)
    pitch: int = 0  # bytes per staged row of x and w
    opitch: int = 0  # bytes per row of the staged output tile
    off_x: int = 0  # shared-memory offsets: the ring, the output tile, the constants
    off_o: int = 0
    off_c: int = 0
    smem: int = 0
    # mma: (blocks walking the row tiles, column tiles); stream: (row tiles
    # x column tiles, column tiles fastest, 1, K parts)
    grid: Tuple[int, ...] = (0, 0)
    # the streamed variant's: bytes of K per slice, row warps (16 rows
    # each) and K warps of a block (wr * wk = 8), bytes of K per block,
    # bytes per ring stage and the offset of the w rows in it
    ks: int = 0
    wr: int = 0
    wk: int = 0
    kchunk: int = 0
    stage: int = 0
    off_w: int = 0


def matmul_pitch(K: int) -> int:
    """Bytes per staged row: K padded to the MMA's depth of 32, then to
    32 mod 64, so that the 8-byte fragment loads of 4 consecutive rows fall
    into 4 different quarters of the 32 banks."""
    kp = -(-K // 32) * 32
    return kp if kp % 64 == 32 else kp + 32


def _ragged_opitch(bn: int, out_f32: bool) -> int:
    """Bytes per staged output row where rows are stored at any byte width
    (N not a multiple of 8, and the streamed variant): a multiple of 16
    with room for a row shifted by up to 15 bytes (the staged byte keeps
    its destination's address mod 16)."""
    return _align16(bn * (4 if out_f32 else 1)) + 16


def _matmul_layout(bn: int, stages: int, pitch: int, out_f32: bool, ragged: bool = False):
    """The mma variant's shared memory, laid out here only: ``bn`` rows of
    w at 0, ``stages`` tiles of ``MM_TILE_M`` rows of x at ``off_x`` (one
    array of rows of ``pitch`` bytes), the output tile at ``off_o``, then
    scale, bias and zp_in * wsum of the block's columns at ``off_c``;
    returns ``(opitch, off_x, off_o, off_c, total bytes)``."""
    opitch = _ragged_opitch(bn, out_f32) if ragged else bn * (4 if out_f32 else 1) + 16
    off_x = bn * pitch
    off_o = off_x + stages * MM_TILE_M * pitch
    off_c = off_o + _align16(MM_TILE_M * opitch)
    return opitch, off_x, off_o, off_c, off_c + 12 * bn


def _stream_layout(wr: int, wk: int, bn: int, stages: int, pitch: int, out_f32: bool):
    """The streamed variant's shared memory: ``stages`` ring stages at 0,
    each ``16 wr`` rows of x then ``bn`` rows of w (at ``off_w``), rows of
    ``pitch`` bytes; after the last slice the K warps but the first leave
    their int32 partial sums from 0 (``MM_STREAM_BN / 8`` fragments of 512
    bytes a warp); the output tile at ``off_o``. Returns ``(stage, off_w,
    opitch, off_o, total bytes)``."""
    tm = 16 * wr
    stage = (tm + bn) * pitch
    red = (wk - 1) * wr * (MM_STREAM_BN // 8) * 512
    opitch = _ragged_opitch(bn, out_f32)
    off_o = _align16(max(stages * stage, red))
    return stage, tm * pitch, opitch, off_o, off_o + tm * opitch


def _resident_plan(M: int, K: int, N: int, out_f32: bool, sms: int) -> Optional[MatmulPlan]:
    """The mma variant's plan, or None where one column tile and one x
    tile do not fit shared memory. Column tiles are as few as
    ``MM_MAX_BN`` allows (x is read once per column tile), but more where
    the row tiles alone would leave SMs idle (the classifier); the ring
    holds about ``MM_INFLIGHT`` bytes of x ahead of the math; the grid is
    persistent: what the card holds at once, dealt over the row tiles."""
    Np = -(-N // 8) * 8
    pitch = matmul_pitch(K)
    m_tiles = -(-M // MM_TILE_M)
    n_split = -(-Np // MM_MAX_BN)
    if m_tiles * n_split < sms:
        n_split = max(n_split, min(Np // 8, -(-sms // m_tiles)))
    bn = -(-(-(-Np // n_split)) // 8) * 8
    stages = min(MM_MAX_STAGES, max(2, -(-MM_INFLIGHT // (MM_TILE_M * K)) + 1))
    ragged = N != Np
    while _matmul_layout(bn, stages, pitch, out_f32, ragged)[-1] > SMEM_BUDGET:
        if stages > 1:
            stages -= 1
        elif bn > 8:
            bn = max(8, bn // 16 * 8)
        else:
            return None
    opitch, off_x, off_o, off_c, smem = _matmul_layout(bn, stages, pitch, out_f32, ragged)
    n_tiles = -(-Np // bn)
    per_sm = max(1, min(MM_BLOCKS_PER_SM, SMEM_PER_SM // (smem + SMEM_PER_BLOCK_RESERVED)))
    return MatmulPlan("mma", bn=bn, stages=stages, pitch=pitch, opitch=opitch, off_x=off_x,
                      off_o=off_o, off_c=off_c, smem=smem,
                      grid=(min(m_tiles, max(1, sms * per_sm // n_tiles)), n_tiles))


def matmul_stream_candidate(M: int, K: int, N: int, out_f32: bool, wr: int, ks: int,
                            stages: int, bn: int, parts: int) -> Optional[MatmulPlan]:
    """The streamed variant's plan with its choices forced: ``wr`` strips
    of 16 rows (the other ``8 / wr`` warps of a strip split its slices),
    ``ks`` bytes of K a slice, ``stages`` slices in the ring, ``bn``
    columns a block, K split over up to ``parts`` blocks; None where the
    kernel cannot run it."""
    wk = 8 // max(wr, 1)
    if (wr not in (1, 2, 4, 8) or ks < 64 or ks & (ks - 1) or ks // 32 < wk
            or bn % 8 or not 8 <= bn <= MM_STREAM_BN or not 2 <= stages <= 8 or parts < 1):
        return None
    pitch = ks + 32
    stage, off_w, opitch, off_o, smem = _stream_layout(wr, wk, bn, stages, pitch, out_f32)
    if smem > SMEM_BUDGET:
        return None
    tiles = -(-M // (16 * wr)) * -(-(-(-N // 8) * 8) // bn)
    n_slices = -(-K // ks)
    kchunk = -(-n_slices // min(parts, n_slices, 65535)) * ks
    return MatmulPlan("stream", bn=bn, stages=stages, pitch=pitch, opitch=opitch,
                      off_o=off_o, smem=smem, grid=(tiles, 1, -(-K // kchunk)), ks=ks,
                      wr=wr, wk=wk, kchunk=kchunk, stage=stage, off_w=off_w)


def _stream_plan(M: int, K: int, N: int, out_f32: bool, sms: int) -> MatmulPlan:
    """The streamed variant's plan. The 8 warps of a block take ``wr``
    strips of 16 rows, as few as cover M (one for a batch-row GEMV), and
    split each K slice between the ``wk = 8 / wr`` warps of a strip.
    Slices are 128 bytes deep (256 where 8 warps split them), the ring as
    deep as 2 blocks per SM allow. Where the tiles leave SMs idle, K is
    also split over up to as many blocks as the card holds at once."""
    wr = 8
    while wr > 1 and 16 * (wr // 2) >= M:
        wr //= 2
    ks = 256 if wr == 1 else 128
    bn = min(MM_STREAM_BN, -(-N // 8) * 8)
    limit = SMEM_PER_SM // MM_STREAM_BLOCKS_PER_SM - SMEM_PER_BLOCK_RESERVED
    stages = MM_STREAM_MAX_STAGES
    while stages > 2 and _stream_layout(wr, 8 // wr, bn, stages, ks + 32, out_f32)[-1] > limit:
        stages -= 1
    plan = matmul_stream_candidate(M, K, N, out_f32, wr, ks, stages, bn, 1)
    tiles = plan.grid[0]
    if tiles < sms:
        per_sm = max(1, min(MM_STREAM_BLOCKS_PER_SM,
                            SMEM_PER_SM // (plan.smem + SMEM_PER_BLOCK_RESERVED)))
        plan = matmul_stream_candidate(M, K, N, out_f32, wr, ks, stages, bn,
                                       max(1, sms * per_sm // tiles))
    return plan


def matmul_plan(M: int, K: int, N: int, out_f32: bool = False, aligned: bool = True,
                sms: int = H100_SMS) -> MatmulPlan:
    """The launch plan of ``x [M, K] . w [N, K]^T`` (N the real output
    columns; w padded to a multiple of 8); shapes and the operands'
    16-byte alignment alone decide it. The mma variant takes every shape
    whose column tile and whole-K x tile fit shared memory, the streamed
    variant the rest (K past ~1.8k), the dp4a variant K that is not a
    multiple of 8 and unaligned operands."""
    if M < 1 or N < 1 or K < 8 or K % 8 or not aligned:
        return MatmulPlan("dp4a")
    return _resident_plan(M, K, N, out_f32, sms) or _stream_plan(M, K, N, out_f32, sms)


def matmul_int8_requant_plain(x: torch.Tensor, op: MatmulRequant) -> torch.Tensor:
    N = op.n_out  # the pad columns are not computed
    # float64 holds every int8 dot product of K <= 2^37 exactly
    acc = x.to(torch.float64) @ op.w[:N].to(torch.float64).T
    acc = acc - op.zp_in * op.wsum[:N].to(torch.float64)
    # f64 -> f32 rounds the integer to nearest even, like int32 -> f32
    f = fma_f32(acc.to(torch.float32), op.scale[:N], op.bias[:N])
    f = torch.clamp(f, op.lo, op.hi)
    if op.out_f32:
        return f
    # pallas_int8.py:63: round(f * (1.0 / s_out)) + zp_out
    q = torch.round(f * op.inv_out) + op.zp_out
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


class _MatmulArgs(ctypes.Structure):
    """Layout of ``MatmulLaunch`` in ``csrc/matmul_int8_requant.cu``: its
    ``MatmulArgs`` (through ``grid_y``), then the streamed variant's
    fields."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("x", "w", "scale", "bias", "wsum", "out")]
        + [(n, ctypes.c_int) for n in ("M", "N", "K", "zp_in")]
        + [(n, ctypes.c_float) for n in ("inv", "zp_out", "lo", "hi")]
        + [(n, ctypes.c_int) for n in (
            "out_f32", "variant", "bn", "stages", "pitch", "opitch", "off_x", "off_o", "off_c",
            "smem", "grid_x", "grid_y", "Np", "grid_z", "ks", "wr", "wk", "kchunk", "stage",
            "off_w")]
        + [("ws", ctypes.c_void_p)]
    )


def _matmul_args(op: MatmulRequant, M: int, aligned: bool) -> _MatmulArgs:
    """The launch arguments of ``op`` on ``M`` rows but the pointers ``x``,
    ``out`` and ``ws``; built once per (M, alignment of x)."""
    a = op.launch_args.get((M, aligned))
    if a is not None:
        return a
    Np, K = op.w.shape
    plan = matmul_plan(M, K, op.n_out, op.out_f32, aligned and _aligned16(op.w),
                       _sm_count(op.w.device))
    a = _MatmulArgs()
    a.w, a.scale, a.bias, a.wsum = (t.data_ptr() for t in (op.w, op.scale, op.bias, op.wsum))
    a.M, a.N, a.Np, a.K, a.zp_in = M, op.n_out, Np, K, op.zp_in
    a.inv, a.zp_out, a.lo, a.hi = op.inv_out, float(op.zp_out), op.lo, op.hi
    a.out_f32, a.variant = int(op.out_f32), MM_VARIANTS.index(plan.variant)
    for n in ("bn", "stages", "pitch", "opitch", "off_x", "off_o", "off_c", "smem", "ks", "wr",
              "wk", "kchunk", "stage", "off_w"):
        setattr(a, n, getattr(plan, n))
    a.grid_x, a.grid_y, a.grid_z = (tuple(plan.grid) + (1,))[:3]
    op.launch_args[(M, aligned)] = a
    return a


def matmul_int8_requant_packed(x: torch.Tensor, op: MatmulRequant) -> torch.Tensor:
    """``x [M, K]`` int8 -> ``[M, N]`` int8 (or f32 when ``op.out_f32``)."""
    name = "matmul_int8_requant"
    if not _route(x, name):
        return matmul_int8_requant_plain(x, op)
    Np, K = op.w.shape
    M = x.shape[0]
    _check(name + " x", x, torch.int8, (M, K), op.w.device)
    out = torch.empty((M, op.n_out), dtype=torch.float32 if op.out_f32 else torch.int8,
                      device=x.device)
    # a copy per call: serving threads may launch the same site at once
    a = _MatmulArgs.from_buffer_copy(_matmul_args(op, M, _aligned16(x)))
    a.x, a.out = x.data_ptr(), out.data_ptr()
    if a.grid_z > 1:
        # K split over blocks: the int32 sums of the output and a counter
        # per output tile, zeroed on the launch's stream, one set per call
        ws = torch.zeros(M * Np + a.grid_x, dtype=torch.int32, device=x.device)
        a.ws = ws.data_ptr()
    with _launch_on(x.device):
        err = _fn("dfq_matmul_int8_requant")(ctypes.byref(a), _stream(x.device))
    _raise_on(err, name)
    _count_launch(name, MM_VARIANTS[a.variant])
    return out


def matmul_int8_requant(x, w, scale, bias, wsum, *, zp_in: int, s_out: float,
                        zp_out: int, act: str = "none", out_f32: bool = False):
    """The JAX package's signature: ``x [M, K]`` int8, ``w [K, N]`` int8,
    per-column ``scale``/``bias`` f32 and ``wsum`` int32."""
    op = pack_matmul(torch.as_tensor(w).T, scale, bias, wsum, zp_in=zp_in, s_out=s_out,
                     zp_out=zp_out, act=act, out_f32=out_f32, device=x.device)
    return matmul_int8_requant_packed(x, op)


# ---------------------------------------------------------------------------
# K2: depthwise 3x3 (stride 1 or 2, pad 1) + requant

# the strip variant of csrc/dw3x3_int8_requant.cu: output pixels along W
# per thread (its STRIP), threads per block (its THREADS), the heights of
# the slab of output rows a thread walks, tallest first, and the threads
# per SM below which a shorter slab is taken
DW_STRIP = 4
DW_THREADS = 128
DW_ROWS = (14, 8, 4, 2)
DW_THREADS_PER_SM = 256


@dataclasses.dataclass
class Dw3x3Requant:
    """Packed operands of one :func:`dw3x3_int8_requant` call site, of
    ``stride`` 1 or 2 (:func:`pack_dw3x3`)."""

    taps: torch.Tensor  # [9, C] int8, HW-major
    scale: torch.Tensor  # [C] f32
    bias: torch.Tensor  # [C] f32
    zp_tapsum: torch.Tensor  # [C] int32: zp_in * sum of the channel's 9 taps
    zp_in: int
    inv_out: float
    zp_out: int
    lo: float
    hi: float
    out_f32: bool
    stride: int = 1

    def __post_init__(self):
        C = self.taps.shape[1]
        _check_operands("dw3x3_int8_requant", self.taps.device,
                        ("taps", self.taps, torch.int8, (9, C)),
                        ("scale", self.scale, torch.float32, (C,)),
                        ("bias", self.bias, torch.float32, (C,)),
                        ("zp_tapsum", self.zp_tapsum, torch.int32, (C,)))


def pack_dw3x3(taps, scale, bias, *, zp_in: int, s_out: float, zp_out: int,
               act: str = "none", out_f32: bool = False, stride: int = 1,
               device=None) -> Dw3x3Requant:
    """``taps``: ``[9, C]`` int8, HW-major. ``device=None`` means CUDA.

    ``stride=2`` packs a site of the engine's stride-2 depthwise convs,
    which the JAX engine runs as XLA convs with its glue epilogue: the
    kernel rounds as that glue does (``inv_out`` is ``f32(1 / f32(s_out))``,
    the quantize clips on the uint8 grid), with no activation clamp and an
    int8 output only."""
    device = resolve_device(device)
    if stride not in (1, 2):
        raise ValueError(f"dw3x3_int8_requant: stride {stride}; expected 1 or 2")
    if stride == 2 and (act != "none" or out_f32):
        raise ValueError("dw3x3_int8_requant: stride 2 takes act='none' and an int8 output")
    lo, hi = _ACT[act]
    taps = _on(taps, device, torch.int8)
    return Dw3x3Requant(
        taps=taps,
        scale=_on(scale, device, torch.float32),
        bias=_on(bias, device, torch.float32),
        # |zp_in| <= 128 and |tapsum| <= 9 * 128: far inside int32
        zp_tapsum=(int(zp_in) * taps.to(torch.int32).sum(0)).to(torch.int32).contiguous(),
        zp_in=int(zp_in), inv_out=(recip_host if stride == 1 else recip_xla)(s_out),
        zp_out=int(zp_out), lo=lo, hi=hi, out_f32=bool(out_f32), stride=stride,
    )


@dataclasses.dataclass(frozen=True)
class Dw3x3Plan:
    """How one K2 call is launched: ``"strip"`` (a thread per channel
    word, ``DW_STRIP`` output pixels and ``rows`` output rows) or
    ``"general"`` (a thread per output byte), ``_s2`` at stride 2, and the
    grid."""

    variant: str
    grid: Tuple[int, int]
    rows: int = 0  # output rows per thread of the strip variant


def dw3x3_plan(N: int, H: int, W: int, C: int, aligned: bool = True,
               sms: int = H100_SMS, stride: int = 1) -> Dw3x3Plan:
    """The strip variant takes channel counts that are whole 32-bit words
    when every operand is 16-byte aligned: grid x covers the (output row
    slab, strip, channel word) items of one image, grid y walks the
    images. A thread walks the tallest slab of ``DW_ROWS`` (a tall slab
    re-reads fewer halo rows) that still leaves ``DW_THREADS_PER_SM``
    threads for every SM, else the shortest. ``H``, ``W``: the input's."""
    OH, OW = -(-H // stride), -(-W // stride)
    suffix = "" if stride == 1 else f"_s{stride}"
    if C % 4 == 0 and aligned:
        for rows in DW_ROWS:
            items = -(-OH // rows) * -(-OW // DW_STRIP) * (C // 4)
            if items * N >= sms * DW_THREADS_PER_SM or rows == DW_ROWS[-1]:
                break
        if 0 < items < 2 ** 31 - DW_THREADS:
            return Dw3x3Plan("strip" + suffix,
                             (-(-items // DW_THREADS), max(1, min(N, 65535))), rows)
    blocks = -(-N * OH * OW * C // DW_THREADS)
    return Dw3x3Plan("general" + suffix, (max(1, min(blocks, 1 << 30)), 1))


def _dw3x3_taps(xp: torch.Tensor, stride: int):
    """The 9 stride-``stride`` views of a once-padded NHWC tensor, in tap
    order (ky, kx), each one output map."""
    _, hp, wp, _ = xp.shape
    oh, ow = (hp - 3) // stride + 1, (wp - 3) // stride + 1
    for ky in range(3):
        for kx in range(3):
            yield ky * 3 + kx, xp[:, ky:ky + stride * (oh - 1) + 1:stride,
                                  kx:kx + stride * (ow - 1) + 1:stride]


def _dw3x3_acc(x_minus_zp: torch.Tensor, taps: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """int32 9-tap MAC over an NHWC tensor already shifted by its zero
    point; the zero padding is the zero point in the int8 domain."""
    taps = taps.to(torch.int32)
    acc = None
    for t, view in _dw3x3_taps(F.pad(x_minus_zp, (0, 0, 1, 1, 1, 1)), stride):
        acc = view * taps[t] if acc is None else acc.add_(view * taps[t])
    return acc


def _dw3x3_epilogue(acc: torch.Tensor, op: Dw3x3Requant) -> torch.Tensor:
    if op.stride == 2:
        # the engine's glue epilogue (engine/int8_fused.py conv steps):
        # one FMA, then the quantize of its _emit
        return quant_u8(fma_f32(acc.to(torch.float32), op.scale, op.bias), op.inv_out,
                        op.zp_out)
    # the Pallas MAC is f32 and exact below 2^24, as is this conversion
    f = torch.clamp(fma_f32(acc.to(torch.float32), op.scale, op.bias), op.lo, op.hi)
    if op.out_f32:
        return f
    # pallas_int8.py:277: round(f * (1.0 / s_out)) + zp_out
    q = torch.round(f * op.inv_out) + op.zp_out
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def dw3x3_int8_requant_plain(x: torch.Tensor, op: Dw3x3Requant) -> torch.Tensor:
    return _dw3x3_epilogue(_dw3x3_acc(x.to(torch.int32) - op.zp_in, op.taps, op.stride), op)


def dw3x3_int8_requant_strip_plain(x: torch.Tensor, op: Dw3x3Requant) -> torch.Tensor:
    """The strip variant's arithmetic, as a second plain version: the halo
    holds ``zp_in``, the MAC runs on the raw int8 values, and the zero
    point leaves as one subtraction of ``zp_in * tapsum``:
    ``sum (x - zp) t = sum x t - zp sum t``. Equal to
    :func:`dw3x3_int8_requant_plain` bit for bit."""
    xp = F.pad(x.to(torch.int32), (0, 0, 1, 1, 1, 1), value=op.zp_in)
    taps = op.taps.to(torch.int32)
    acc = -op.zp_tapsum
    for t, view in _dw3x3_taps(xp, op.stride):
        acc = acc + view * taps[t]
    return _dw3x3_epilogue(acc, op)


def dw3x3_int8_requant_packed(x: torch.Tensor, op: Dw3x3Requant) -> torch.Tensor:
    """``x [N, H, W, C]`` int8 -> ``[N, ceil(H / s), ceil(W / s), C]`` int8
    (or f32), ``s`` the site's stride."""
    name = "dw3x3_int8_requant"
    if not _route(x, name):
        return dw3x3_int8_requant_plain(x, op)
    C = op.taps.shape[1]
    if x.dim() != 4:
        raise ValueError(f"{name}: expected NHWC input, got shape {tuple(x.shape)}")
    N, H, W, _ = x.shape
    _check(name + " x", x, torch.int8, (N, H, W, C), op.taps.device)
    s = op.stride
    out = torch.empty((N, -(-H // s), -(-W // s), C),
                      dtype=torch.float32 if op.out_f32 else torch.int8, device=x.device)
    plan = dw3x3_plan(N, H, W, C,
                      _aligned16(x, out, op.taps, op.scale, op.bias, op.zp_tapsum),
                      _sm_count(x.device), s)
    operands = (x.data_ptr(), op.taps.data_ptr(), op.scale.data_ptr(), op.bias.data_ptr(),
                op.zp_tapsum.data_ptr(), out.data_ptr(), N, H, W, C, op.zp_in, op.inv_out)
    with _launch_on(x.device):
        launch = (int(plan.variant.startswith("strip")), DW_STRIP, plan.rows, plan.grid[0],
                  plan.grid[1], _stream(x.device))
        if s == 1:
            err = _fn("dfq_dw3x3_int8_requant")(
                *operands, float(op.zp_out), op.lo, op.hi, int(op.out_f32), *launch)
        else:
            err = _fn("dfq_dw3x3_s2_int8_requant")(*operands, float(op.zp_out + 128), *launch)
    _raise_on(err, name)
    _count_launch(name, plan.variant)
    return out


def dw3x3_int8_requant(x, w, scale, bias, *, zp_in: int, s_out: float, zp_out: int,
                       act: str = "none", out_f32: bool = False):
    """The JAX package's signature: ``x [N, H, W, C]`` int8, ``w [9, C]``
    int8 taps (HW-major)."""
    op = pack_dw3x3(w, scale, bias, zp_in=zp_in, s_out=s_out, zp_out=zp_out, act=act,
                    out_f32=out_f32, device=x.device)
    return dw3x3_int8_requant_packed(x, op)


# ---------------------------------------------------------------------------
# K3: fused inverted-residual block


def _fused_block_layout(bh: int, W: int, C: int, E: int) -> Tuple[int, int, int]:
    """The general variant's shared memory, laid out here only and passed
    to the kernel:
    the staged input rows ``[bh+2][W][C]`` at 0, the expanded tile with
    its halo ``[bh+2][W+2][E]`` at ``off_e``, the depthwise output tile
    ``[bh][W][E]`` at ``off_d``; returns ``(off_e, off_d, total bytes)``."""
    off_e = _align16((bh + 2) * W * C)
    off_d = off_e + _align16((bh + 2) * (W + 2) * E)
    return off_e, off_d, off_d + _align16(bh * W * E)


def fused_block_smem(bh: int, W: int, C: int, E: int) -> int:
    """Shared memory (bytes) of one thread block of ``bh`` rows of the
    general variant."""
    return _fused_block_layout(bh, W, C, E)[2]


@functools.lru_cache(maxsize=None)
def fused_block_fits(H: int, W: int, C: int, E: int, C2: int) -> bool:
    """True when K3 takes the block (the engine asks on every forward, so
    the answer is kept): channel counts are multiples of 4
    (one 32-bit word of int8) and either the tensor-core variant has a
    plan for it or a one-row slab of the general variant fits the
    shared-memory budget. The engine runs the block unfused otherwise.

    The answer is for input as the engine gives it: contiguous tensors on
    16-byte boundaries. A shape that only the tensor-core variant can hold
    raises a ValueError at the launch when x or out is off that boundary."""
    if C % 4 or E % 4 or C2 % 4:
        return False
    return (fused_block_plan(1, H, W, C, E, C2).variant == "mma"
            or fused_block_smem(1, W, C, E) <= SMEM_BUDGET)


def fused_block_rows(H: int, W: int, C: int, E: int) -> int:
    """Output rows per thread block of the general variant: slabs of at most 8 rows (more blocks
    in flight; the 2 halo rows cost (bh+2)/bh in recomputed expand work),
    evened out over H, then shrunk until the slab fits the budget."""
    n_h = -(-H // 8)
    bh = -(-H // n_h)
    while bh > 1 and fused_block_smem(bh, W, C, E) > SMEM_BUDGET:
        bh -= 1
    return bh


# the tensor-core variant of csrc/fused_block_int8.cu: the (WM, WN) blocks
# of m16n8 accumulator tiles a warp can own (its template instances), the
# warps of a block (its NW; one block an SM, 128 registers a thread), the
# tallest slab, the pixel tiles of one expand item (its EXP_NT)
FB_WARP_TILES = ((2, 4), (4, 3), (2, 6))
FB_WARPS = 16
FB_MAX_ROWS = 14
FB_EXPAND_TILES = 4


@dataclasses.dataclass(frozen=True)
class FusedBlockPlan:
    """How one K3 call is launched. ``variant`` is ``"mma"`` (E walked in
    chunks, tensor-core GEMMs) or ``"general"`` (the whole expanded tile
    in shared memory, every shape :func:`fused_block_fits` admits); the
    other fields are the mma variant's but ``bh``, ``off_e``, ``off_d``,
    ``smem`` and ``grid``, which both have."""

    variant: str
    bh: int = 0  # output rows per block
    off_e: int = 0  # shared-memory offsets: e tile, d tile, weight buffers
    off_d: int = 0
    smem: int = 0
    grid: Tuple[int, int] = (0, 0)  # (images x slabs, blocks sharing the columns)
    ec: int = 0  # channels of E per chunk
    nk: int = 0  # chunks
    wx: int = 0  # pixels per staged image row: W rounded up to 8
    wp: int = 0  # bytes per (row, channel) of the e tile
    p1: int = 0  # bytes per staged row of K = C (x, w1)
    p2: int = 0  # bytes per staged row of K = ec (d tile, w2)
    mt: int = 0  # m16 pixel tiles of a block
    ntb: int = 0  # n8 column tiles of a block
    wm: int = 0  # accumulator tiles per warp, along m and n
    wn: int = 0
    wgm: int = 0  # warps along m (FB_WARPS / wgm along n)
    dr: int = 0  # output rows per depthwise item
    off_t: int = 0  # the table of pixel tiles
    off_w: int = 0
    wbuf: int = 0  # bytes of one weight buffer
    fpitch: int = 0  # floats per pixel of the staged project output

    @property
    def acc_regs(self) -> int:
        return 4 * self.wm * self.wn


def _fused_block_image_of(ec: int, C: int, E: int, C2: int):
    p1, p2 = matmul_pitch(C), matmul_pitch(ec)
    img_c = ec * p1
    img_w2 = img_c + 36 * ec
    return ec, -(-E // ec), p1, p2, img_c, img_w2, img_w2 + C2 * p2


def fused_block_ec(C: int, E: int, C2: int) -> int:
    """Channels of E per chunk of the tensor-core variant: 128, 64 or 32
    (whole m16 tiles that divide the block's 16 warps; a multiple of the
    MMA's depth of 32). Every chunk costs the block three barriers, so the
    widest chunk is taken that pads E by at most an eighth (the padded
    channels are computed like any other) and whose two weight buffers
    leave 3/10 of the shared memory to the tiles; where none does, the one
    that pads least among those that leave the room, else 32."""
    roomy = [ec for ec in (128, 64, 32)
             if 10 * 2 * _fused_block_image_of(ec, C, E, C2)[-1] <= 7 * SMEM_BUDGET] or [32]
    padded = {ec: -(-E // ec) * ec for ec in roomy}
    for ec, ep in padded.items():
        if 8 * (ep - E) <= E:
            return ec
    return min(padded, key=lambda ec: (padded[ec], -ec))


def fused_block_image(C: int, E: int, C2: int) -> Tuple[int, int, int, int, int, int, int]:
    """The chunk image the tensor-core variant copies per chunk, in its
    shared-memory layout: ``ec`` rows of w1 (``[channel][p1]``, K = C
    zero-padded), at ``img_c`` nine arrays of ``ec`` 4-byte constants
    (sc1, b1, zp_c1 * ws1, scd, bd, zp_e * tapsum, and the taps of rows
    ky = 0, 1, 2 as words ``(t0, t1, t2, 0)``), at ``img_w2`` C2 rows of w2
    (``[column][p2]``, K = ec). Returns ``(ec, nk, p1, p2, img_c, img_w2,
    img_stride)``."""
    return _fused_block_image_of(fused_block_ec(C, E, C2), C, E, C2)


def _fused_block_mma_layout(bh: int, mt: int, ntb: int, W: int, C: int, E: int, C2: int):
    """The tensor-core variant's shared memory: the x slab
    ``[(bh+2) * wx][p1]`` at 0, the e tile ``[bh+3][ec][wp]`` at ``off_e``,
    the d tile ``[mt * 16][p2]`` at ``off_d``, the table of pixel tiles
    (one word per 8 staged pixels, whole expand items) at ``off_t``, two
    weight buffers of ``wbuf`` bytes at ``off_w``; returns ``(off_e, off_d, off_t, off_w,
    wbuf, total)``."""
    ec, _, p1, p2, _, img_w2, _ = fused_block_image(C, E, C2)
    wx = -(-W // 8) * 8
    off_e = _align16((bh + 2) * wx * p1)
    # one spare row of the e tile takes what the table's padding tiles write
    off_d = off_e + _align16((bh + 3) * ec * (wx + 12))
    off_t = off_d + _align16(mt * 16 * p2)
    off_w = off_t + _align16(-(-(bh + 2) * wx // 8 // FB_EXPAND_TILES) * FB_EXPAND_TILES * 4)
    wbuf = img_w2 + ntb * 8 * p2
    return off_e, off_d, off_t, off_w, wbuf, off_w + 2 * wbuf


def _fused_block_warp_tiles(mt: int, ntb: int):
    """The smallest (WM, WN) instance and the grid of the block's warps
    (powers of two along m) that cover ``mt`` x ``ntb`` tiles: ``(wm, wn,
    wgm)`` or None."""
    best = None
    for (wm, wn) in FB_WARP_TILES:
        wgm = FB_WARPS
        while wgm >= 1:
            wgn = FB_WARPS // wgm
            if wgm * wm >= mt and wgn * wn >= ntb:
                # fewest registers, then the least idle tile slots
                key = (wm * wn, wgm * wm * wgn * wn - mt * ntb, -wgm)
                if best is None or key < best[0]:
                    best = (key, (wm, wn, wgm))
            wgm //= 2
    return None if best is None else best[1]


def fused_block_candidate(N: int, H: int, W: int, C: int, E: int, C2: int, bh: int,
                          csplit: int) -> Optional[FusedBlockPlan]:
    """The tensor-core variant's plan with slabs of ``bh`` rows and the
    output columns shared by ``csplit`` blocks, or None where the kernel
    cannot run it: C or C2 not a multiple of 8, a block without columns,
    no warp tiling that covers the block, or too much shared memory."""
    if (N < 1 or C % 8 or C2 % 8 or E % 4 or C < 8 or C2 < 8 or E < 4
            or not 1 <= bh <= min(H, FB_MAX_ROWS) or csplit < 1):
        return None
    ec, nk, p1, p2, _, _, _ = fused_block_image(C, E, C2)
    wx = -(-W // 8) * 8
    nt = C2 // 8
    mt = -(-bh * wx // 16)
    ntb = -(-nt // csplit)
    if (csplit - 1) * ntb >= nt:  # the last block would have no column
        return None
    tiles = _fused_block_warp_tiles(mt, ntb)
    if tiles is None:
        return None
    wm, wn, wgm = tiles
    off_e, off_d, off_t, off_w, wbuf, total = _fused_block_mma_layout(bh, mt, ntb, W, C, E, C2)
    # after the last chunk the project output is staged over all of it:
    # bh * W pixels of fpitch floats (8 mod 32: conflict-free stores)
    fpitch = max(0, -(-(ntb * 8 - 8) // 32)) * 32 + 8
    smem = max(total, _align16(bh * W * fpitch * 4))
    if smem > SMEM_BUDGET:
        return None
    # depthwise items: (channel, strip, run of dr rows); the fewest rounds of
    # the block's threads times the rows a round walks (2 more are loaded)
    strips = -(-W // 4)
    dr = min(range(1, bh + 1),
             key=lambda d: (-(-ec * strips * -(-bh // d) // (32 * FB_WARPS)) * (d + 2), -d))
    return FusedBlockPlan(
        "mma", bh=bh, off_e=off_e, off_d=off_d, smem=smem, grid=(N * -(-H // bh), csplit),
        ec=ec, nk=nk, wx=wx, wp=wx + 12, p1=p1, p2=p2, mt=mt, ntb=ntb, wm=wm, wn=wn,
        wgm=wgm, dr=dr, off_t=off_t, off_w=off_w, wbuf=wbuf, fpitch=fpitch)


def fused_block_plan(N: int, H: int, W: int, C: int, E: int, C2: int, aligned: bool = True,
                     sms: int = H100_SMS) -> FusedBlockPlan:
    """The launch plan of one K3 call; shapes, the batch and the 16-byte
    alignment of x and out alone decide it, and the variant does not
    depend on the batch or on ``sms``.

    The tensor-core variant takes C and C2 that are multiples of 8 (E a
    multiple of 4; it is padded to whole chunks in the packed weights)
    with aligned x and out, whenever a slab of at least one row fits its
    tiles (``wx``-pixel rows as m16 tiles over an instance of
    ``FB_WARP_TILES``) and shared memory, its output columns shared by 2
    or 4 blocks where no slab holds them all. Slabs are at most
    ``FB_MAX_ROWS`` rows, evened out over H; where that leaves a quarter of the SMs or more
    without a block the slabs are halved (down to 2 rows: each halving
    recomputes more halo rows of the expand), then the output columns are
    split over up to 4 blocks, each of which recomputes expand and depthwise."""
    general = FusedBlockPlan("general")
    if not aligned or N < 1 or H < 1:
        return general

    def candidate(bh, csplit):
        return fused_block_candidate(N, H, W, C, E, C2, bh, csplit)

    def evened(rows):
        return -(-H // -(-H // rows))

    nt = C2 // 8
    bh, csplit = evened(min(H, FB_MAX_ROWS)), 1
    while candidate(bh, csplit) is None:
        if bh > 1:
            bh = evened(bh - 1)
        elif csplit < 4 and nt % (2 * csplit) == 0 and nt // (2 * csplit) >= 2:
            # no slab holds all the output columns (MobileNetV1's C2 = 1024):
            # share them out, whatever the batch
            bh, csplit = evened(min(H, FB_MAX_ROWS)), 2 * csplit
        else:
            break
    # more blocks where a quarter of the card or more would stand idle
    while 4 * N * -(-H // bh) * csplit < 3 * sms:
        if bh > 2 and candidate(evened(-(-bh // 2)), csplit):
            bh = evened(-(-bh // 2))
        elif csplit < 4 and nt % (2 * csplit) == 0 and nt // (2 * csplit) >= 2 \
                and candidate(bh, 2 * csplit):
            csplit *= 2
        else:
            break
    return candidate(bh, csplit) or general


@dataclasses.dataclass
class FusedBlock:
    """Packed operands and host-rounded constants of one K3 call site."""

    w1: torch.Tensor  # [C/4, E] int32 words: bytes w1[4i..4i+3, e]
    sc1: torch.Tensor
    b1: torch.Tensor
    ws1: torch.Tensor
    wd: torch.Tensor  # [9, E] int8
    scd: torch.Tensor
    bd: torch.Tensor
    w2: torch.Tensor  # [E/4, C2] int32 words
    sc2: torch.Tensor
    b2: torch.Tensor
    ws2: torch.Tensor
    # the tensor-core variant's operands: the chunk images of
    # fused_block_image(), one after another, and zp_d * ws2
    wimg: torch.Tensor  # [nk * img_stride] int8
    zw2: torch.Tensor  # [C2] int32
    C: int
    E: int
    C2: int
    req_c1: int
    zp_x: int
    ratio_c1: float
    zp_c1: int
    r_e: float
    lo_e: float
    hi_e: float
    zp_e: int
    r_d: float
    lo_d: float
    hi_d: float
    zp_d: int
    res: int
    req_r: int
    ratio_r: float
    zp_r: int
    s_r: float
    c_r: float
    r_p: float
    zp_p: int
    s_p: float
    c_p: float
    out_f32: int
    r_o: float
    zp_o: int
    # launch arguments by (N, H, W, x and out are 16-byte aligned), all but
    # the pointers x, out
    launch_args: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        C, E, C2 = self.C, self.E, self.C2
        f, i32 = torch.float32, torch.int32
        _check_operands(
            "fused_block_int8", self.w1.device,
            ("w1", self.w1, i32, (C // 4, E)), ("sc1", self.sc1, f, (E,)),
            ("b1", self.b1, f, (E,)), ("ws1", self.ws1, i32, (E,)),
            ("wd", self.wd, torch.int8, (9, E)), ("scd", self.scd, f, (E,)),
            ("bd", self.bd, f, (E,)), ("w2", self.w2, i32, (E // 4, C2)),
            ("sc2", self.sc2, f, (C2,)), ("b2", self.b2, f, (C2,)),
            ("ws2", self.ws2, i32, (C2,)), ("zw2", self.zw2, i32, (C2,)),
            ("wimg", self.wimg, torch.int8,
             (fused_block_image(C, E, C2)[1] * fused_block_image(C, E, C2)[-1],)))


def _pack_words(w: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` int8 -> ``[K/4, N]`` int32 words of 4 consecutive k."""
    K, N = w.shape
    return (w.reshape(K // 4, 4, N).permute(0, 2, 1).contiguous()
            .view(torch.int32).reshape(K // 4, N))


def _unpack_words(words: torch.Tensor) -> torch.Tensor:
    K4, N = words.shape
    return words.contiguous().view(torch.int8).reshape(K4, N, 4).permute(0, 2, 1).reshape(4 * K4, N)


def _pack_fused_block_image(w1, sc1, b1, ws1, wd, scd, bd, w2, zp_c1: int,
                            zp_e: int) -> torch.Tensor:
    """The chunk images of :func:`fused_block_image` from the JAX-layout
    CPU operands (``w1 [C, E]``, ``wd [9, E]``, ``w2 [E, C2]`` int8).
    Channels past E are zeros throughout: zero weights, scales, biases
    and taps give e = zp_e and d = zp_d, which meet zero rows of w2."""
    C, E = w1.shape
    C2 = w2.shape[1]
    ec, nk, p1, p2, img_c, img_w2, stride = fused_block_image(C, E, C2)
    Ep = nk * ec
    i32 = np.int32

    def padded(a, dtype):  # [..., E] -> [..., Ep]
        out = np.zeros(a.shape[:-1] + (Ep,), dtype)
        out[..., :E] = a
        return out

    w1p, wdp, w2p = padded(w1, np.int8), padded(wd, np.int8), np.zeros((Ep, C2), np.int8)
    w2p[:E] = w2
    taps = np.zeros((3, Ep, 4), np.int8)  # words (t[3 ky], t[3 ky + 1], t[3 ky + 2], 0)
    taps[:, :, :3] = wdp.reshape(3, 3, Ep).transpose(0, 2, 1)
    consts = np.stack([
        padded(sc1, np.float32).view(i32), padded(b1, np.float32).view(i32),
        zp_c1 * padded(ws1, i32), padded(scd, np.float32).view(i32),
        padded(bd, np.float32).view(i32), zp_e * wdp.astype(i32).sum(0),
        *taps.reshape(3, Ep * 4).view(i32)]).astype(i32)  # [9, Ep]
    img = np.zeros((nk, stride), np.int8)
    for k in range(nk):
        ch = slice(k * ec, (k + 1) * ec)
        rows1 = np.zeros((ec, p1), np.int8)
        rows1[:, :C] = w1p[:, ch].T
        rows2 = np.zeros((C2, p2), np.int8)
        rows2[:, :ec] = w2p[ch].T
        img[k, :img_c] = rows1.reshape(-1)
        img[k, img_c:img_w2] = np.ascontiguousarray(consts[:, ch]).view(np.int8).reshape(-1)
        img[k, img_w2:] = rows2.reshape(-1)
    return torch.from_numpy(img.reshape(-1))


def _act_q(act_hi: float, grid: Tuple[float, int]) -> int:
    # pallas_int8.py:552-553: host f64 int-domain bound
    return int(np.clip(np.round(act_hi / grid[0]) + grid[1], -128, 127))


def pack_fused_block(
    w1, scale1, bias1, wsum1, wd, scale_d, bias_d, w2, scale2, bias2, wsum2, *,
    x_grid: Tuple[float, int], c1_grid: Tuple[float, int],
    e_grid: Tuple[float, int], d_grid: Tuple[float, int],
    act1_hi: float, act2_hi: float,
    res_grid: Optional[Tuple[float, int]] = None,
    p_grid: Optional[Tuple[float, int]] = None,
    out_grid: Optional[Tuple[float, int]] = None,
    device=None,
) -> FusedBlock:
    """Weights in the JAX layouts: ``w1 [C, E]``, ``wd [9, E]``,
    ``w2 [E, C2]`` int8; per-channel ``scaleX = s_in * s_w`` f32 and
    ``wsumX`` int32. ``out_grid=None`` gives f32 output. ``device=None``
    means CUDA."""
    device = resolve_device(device)
    w1 = torch.as_tensor(w1)
    w2 = torch.as_tensor(w2)
    C, E = w1.shape
    C2 = w2.shape[1]
    if C % 4 or E % 4 or C2 % 4:
        raise ValueError(f"fused_block_int8: channels ({C}, {E}, {C2}) must be multiples of 4")
    res = res_grid is not None
    if res and C != C2:
        raise ValueError("residual fusion requires in_ch == out_ch")
    if res and p_grid is None:
        raise ValueError("res_grid requires p_grid")
    s_x, zp_x = float(x_grid[0]), int(x_grid[1])
    s_c1, zp_c1 = float(c1_grid[0]), int(c1_grid[1])
    s_e, zp_e = float(e_grid[0]), int(e_grid[1])
    s_d, zp_d = float(d_grid[0]), int(d_grid[1])
    s_r, zp_r = (float(res_grid[0]), int(res_grid[1])) if res else (1.0, 0)
    s_p, zp_p = (float(p_grid[0]), int(p_grid[1])) if res else (1.0, 0)
    s_o, zp_o = (float(out_grid[0]), int(out_grid[1])) if out_grid else (1.0, 0)

    def host(t, dtype):
        return torch.as_tensor(t).detach().cpu().numpy().astype(dtype)

    wimg = _pack_fused_block_image(
        host(w1, np.int8), host(scale1, np.float32), host(bias1, np.float32),
        host(wsum1, np.int32), host(wd, np.int8), host(scale_d, np.float32),
        host(bias_d, np.float32), host(w2, np.int8), zp_c1, zp_e)
    return FusedBlock(
        w1=_pack_words(w1.to(torch.int8)).to(device), sc1=_on(scale1, device, torch.float32),
        b1=_on(bias1, device, torch.float32), ws1=_on(wsum1, device, torch.int32),
        wd=_on(wd, device, torch.int8), scd=_on(scale_d, device, torch.float32),
        bd=_on(bias_d, device, torch.float32),
        w2=_pack_words(w2.to(torch.int8)).to(device), sc2=_on(scale2, device, torch.float32),
        b2=_on(bias2, device, torch.float32), ws2=_on(wsum2, device, torch.int32),
        wimg=wimg.to(device),
        # |zp_d| <= 128 and |ws2| <= 128 E: inside int32 for every E < 2^17
        zw2=(zp_d * _on(wsum2, device, torch.int32)).to(torch.int32).contiguous(),
        C=C, E=E, C2=C2,
        # x -> c1 requant (pallas_int8.py:449-453); ratio is Python's f64 s_x/s_c1
        req_c1=int((s_x, zp_x) != (s_c1, zp_c1)), zp_x=zp_x, ratio_c1=f32(s_x / s_c1),
        zp_c1=zp_c1,
        # f1 / s_e and fd / s_d under XLA: * f32(1/f32(s))
        r_e=recip_xla(s_e), lo_e=float(zp_e + 128), hi_e=float(_act_q(act1_hi, e_grid) + 128),
        zp_e=zp_e,
        r_d=recip_xla(s_d), lo_d=float(zp_d + 128), hi_d=float(_act_q(act2_hi, d_grid) + 128),
        zp_d=zp_d,
        res=int(res), req_r=int(res and (s_x, zp_x) != (s_r, zp_r)),
        ratio_r=f32(s_x / s_r), zp_r=zp_r,
        # x * s - zp * s: the product zp * s is Python's, rounded once
        s_r=f32(s_r), c_r=-f32(zp_r * s_r),
        r_p=recip_xla(s_p), zp_p=zp_p, s_p=f32(s_p), c_p=-f32(zp_p * s_p),
        out_f32=int(out_grid is None), r_o=recip_xla(s_o), zp_o=zp_o,
    )


def fused_block_int8_plain(x: torch.Tensor, op: FusedBlock) -> torch.Tensor:
    """Whole-image version of the block: the halo rows that K3 forces to
    f = 0 quantize to exactly zp_e, which is the zero padding here."""
    N, H, W, C = x.shape
    E, C2 = op.E, op.C2
    w1 = _unpack_words(op.w1).to(torch.float64)
    w2 = _unpack_words(op.w2).to(torch.float64)
    xc = requant_i8(x, op.zp_x, op.ratio_c1, op.zp_c1) if op.req_c1 else x
    a1 = xc.reshape(-1, C).to(torch.float64) @ w1 - op.zp_c1 * op.ws1.to(torch.float64)
    f1 = fma_f32(a1.to(torch.float32), op.sc1, op.b1)
    q1 = quant_u8(f1, op.r_e, op.zp_e, op.lo_e, op.hi_e).reshape(N, H, W, E)
    acc = _dw3x3_acc(q1.to(torch.int32) - op.zp_e, op.wd)
    fd = fma_f32(acc.to(torch.float32), op.scd, op.bd)
    qd = quant_u8(fd, op.r_d, op.zp_d, op.lo_d, op.hi_d)
    a2 = qd.reshape(-1, E).to(torch.float64) @ w2 - op.zp_d * op.ws2.to(torch.float64)
    f2 = fma_f32(a2.to(torch.float32), op.sc2, op.b2).reshape(N, H, W, C2)
    if op.res:
        # pallas_int8.py:497-511: both operands through the add's site grids
        q2 = quant_u8(f2, op.r_p, op.zp_p).to(torch.float32)
        bf = fma_f32(q2, op.s_p, op.c_p)
        xr = requant_i8(x, op.zp_x, op.ratio_r, op.zp_r) if op.req_r else x
        af = fma_f32(xr.to(torch.float32), op.s_r, op.c_r)
        f2 = af + bf
    if op.out_f32:
        return f2
    return quant_u8(f2, op.r_o, op.zp_o)


class _FusedBlockArgs(ctypes.Structure):
    """Layout of ``FusedBlockArgs`` in ``csrc/fused_block_int8.cu``."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in (
            "x", "w1", "sc1", "b1", "ws1", "wd", "scd", "bd", "w2", "sc2", "b2",
            "ws2", "out", "wimg", "zw2")]
        + [(n, ctypes.c_int) for n in ("N", "H", "W", "C", "E", "C2", "bh")]
        + [(n, ctypes.c_int) for n in ("off_e", "off_d", "smem", "req_c1", "zp_x")]
        + [("ratio_c1", ctypes.c_float), ("zp_c1_128", ctypes.c_float), ("zp_c1", ctypes.c_int)]
        + [(n, ctypes.c_float) for n in ("r_e", "lo_e", "hi_e")] + [("zp_e", ctypes.c_int)]
        + [(n, ctypes.c_float) for n in ("r_d", "lo_d", "hi_d")] + [("zp_d", ctypes.c_int)]
        + [("res", ctypes.c_int), ("req_r", ctypes.c_int)]
        + [(n, ctypes.c_float) for n in (
            "ratio_r", "zp_r_128", "s_r", "c_r", "r_p", "zp_p_128", "s_p", "c_p")]
        + [("out_f32", ctypes.c_int), ("r_o", ctypes.c_float), ("zp_o_128", ctypes.c_float)]
        + [(n, ctypes.c_int) for n in (
            "mma", "ec", "nk", "wx", "wp", "p1", "p2", "mt", "ntb", "csplit", "wm", "wn",
            "wgm", "dr", "off_t", "off_w", "wbuf", "fpitch", "img_c", "img_w2", "img_stride")]
    )


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: library source, return type, argument types
_SIGNATURES = {
    "dfq_matmul_int8_requant": (
        "matmul_int8_requant.cu", _I, [ctypes.POINTER(_MatmulArgs), _P]),
    "dfq_dw3x3_int8_requant": (
        "dw3x3_int8_requant.cu", _I, [_P] * 6 + [_I] * 5 + [_F] * 4 + [_I] * 6 + [_P]),
    "dfq_dw3x3_s2_int8_requant": (
        "dw3x3_int8_requant.cu", _I, [_P] * 6 + [_I] * 5 + [_F] * 2 + [_I] * 5 + [_P]),
    "dfq_fused_block_int8": (
        "fused_block_int8.cu", _I, [ctypes.POINTER(_FusedBlockArgs), _P]),
}
_FNS: dict = {}


def _fn(name: str):
    """A C entry point with its argument and return types declared (the
    library is built and loaded at first use)."""
    fn = _FNS.get(name)
    if fn is None:
        source, restype, argtypes = _SIGNATURES[name]
        fn = getattr(_build.library(source), name)
        fn.restype, fn.argtypes = restype, argtypes
        _FNS[name] = fn
    return fn


def _fused_block_args(op: FusedBlock, N: int, H: int, W: int,
                      aligned: bool) -> _FusedBlockArgs:
    """The launch arguments of ``op`` on ``N`` images of ``H x W`` but the
    pointers ``x`` and ``out``; built once per (N, H, W, alignment)."""
    a = op.launch_args.get((N, H, W, aligned))
    if a is not None:
        return a
    if not fused_block_fits(H, W, op.C, op.E, op.C2):
        raise ValueError(f"fused_block_int8: block {(H, W, op.C, op.E, op.C2)} does not fit")
    # the tensor-core variant quantizes e and d with their zero points as the
    # lower bounds (an activation floor at 0), as pack_fused_block makes them
    relu = (op.lo_e == op.zp_e + 128 <= op.hi_e and op.lo_d == op.zp_d + 128 <= op.hi_d)
    if (not (aligned and relu) and fused_block_smem(1, W, op.C, op.E) > SMEM_BUDGET):
        raise ValueError(
            f"fused_block_int8: block {(H, W, op.C, op.E, op.C2)} runs only in the "
            "tensor-core variant (one row of its whole expanded tile takes "
            f"{fused_block_smem(1, W, op.C, op.E)} bytes of shared memory, over the "
            f"{SMEM_BUDGET} of the general variant), which needs x and out on 16-byte "
            "boundaries and activation floors at the zero points "
            f"(aligned: {aligned}, floors at the zero points: {relu})")
    plan = fused_block_plan(N, H, W, op.C, op.E, op.C2, aligned and relu,
                            _sm_count(op.w1.device))
    a = _FusedBlockArgs()
    for n in ("w1", "sc1", "b1", "ws1", "wd", "scd", "bd", "w2", "sc2", "b2", "ws2", "wimg",
              "zw2"):
        setattr(a, n, getattr(op, n).data_ptr())
    a.N, a.H, a.W, a.C, a.E, a.C2 = N, H, W, op.C, op.E, op.C2
    a.mma = int(plan.variant == "mma")
    if a.mma:
        for n in ("bh", "off_e", "off_d", "smem", "ec", "nk", "wx", "wp", "p1", "p2", "mt",
                  "ntb", "wm", "wn", "wgm", "dr", "off_t", "off_w", "wbuf", "fpitch"):
            setattr(a, n, getattr(plan, n))
        a.csplit = plan.grid[1]
        a.img_c, a.img_w2, a.img_stride = fused_block_image(op.C, op.E, op.C2)[4:]
    else:
        a.bh = fused_block_rows(H, W, op.C, op.E)
        a.off_e, a.off_d, a.smem = _fused_block_layout(a.bh, W, op.C, op.E)
    for n in ("req_c1", "zp_x", "ratio_c1", "zp_c1", "r_e", "lo_e", "hi_e", "zp_e",
              "r_d", "lo_d", "hi_d", "zp_d", "res", "req_r", "ratio_r", "s_r", "c_r",
              "r_p", "s_p", "c_p", "out_f32", "r_o"):
        setattr(a, n, getattr(op, n))
    a.zp_c1_128, a.zp_r_128 = float(op.zp_c1 + 128), float(op.zp_r + 128)
    a.zp_p_128, a.zp_o_128 = float(op.zp_p + 128), float(op.zp_o + 128)
    op.launch_args[(N, H, W, aligned)] = a
    return a


def fused_block_int8_packed(x: torch.Tensor, op: FusedBlock) -> torch.Tensor:
    """``x [N, H, W, C]`` int8 on the x grid -> ``[N, H, W, C2]`` int8 on
    the out grid (or f32)."""
    name = "fused_block_int8"
    if not _route(x, name):
        return fused_block_int8_plain(x, op)
    if x.dim() != 4:
        raise ValueError(f"{name}: expected NHWC input, got shape {tuple(x.shape)}")
    N, H, W, C = x.shape
    _check(name + " x", x, torch.int8, (N, H, W, op.C), op.w1.device)
    if x.data_ptr() % 4:
        raise ValueError(f"{name}: x must be 4-byte aligned")
    out = torch.empty((N, H, W, op.C2),
                      dtype=torch.float32 if op.out_f32 else torch.int8, device=x.device)
    # a copy per call: serving threads may launch the same block at once
    a = _FusedBlockArgs.from_buffer_copy(_fused_block_args(op, N, H, W, _aligned16(x, out)))
    a.x, a.out = x.data_ptr(), out.data_ptr()
    with _launch_on(x.device):
        err = _fn("dfq_fused_block_int8")(ctypes.byref(a), _stream(x.device))
    _raise_on(err, name)
    _count_launch(name, "mma" if a.mma else "general")
    return out


def fused_block_int8(
    x, w1, scale1, bias1, wsum1, wd, scale_d, bias_d, w2, scale2, bias2, wsum2, *,
    x_grid, c1_grid, e_grid, d_grid, act1_hi, act2_hi,
    res_grid=None, p_grid=None, out_grid=None,
):
    """The JAX package's signature (without its VMEM budget)."""
    op = pack_fused_block(
        w1, scale1, bias1, wsum1, wd, scale_d, bias_d, w2, scale2, bias2, wsum2,
        x_grid=x_grid, c1_grid=c1_grid, e_grid=e_grid, d_grid=d_grid,
        act1_hi=act1_hi, act2_hi=act2_hi, res_grid=res_grid, p_grid=p_grid,
        out_grid=out_grid, device=x.device,
    )
    return fused_block_int8_packed(x, op)
