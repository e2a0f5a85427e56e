"""The int8 kernels of the inference hot path, written by hand for Hopper.

Three CUDA kernels (sources in ``dfq_tpu_torch/csrc``) replace the three
Pallas TPU kernels of ``dfq_tpu/ops/pallas_int8.py``:

- :func:`matmul_int8_requant` (K1): pointwise convs and the classifier
  as an ``[M, K] x [K, N]`` int8 matmul with the requant epilogue fused.
- :func:`dw3x3_int8_requant` (K2): NHWC depthwise 3x3, stride 1.
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
_count_lock = threading.Lock()

# the activation clamp of K1/K2 (pallas_int8.py:90-91)
_ACT = {"none": (-3.4e38, 3.4e38), "relu": (0.0, 3.4e38), "relu6": (0.0, 6.0)}

# the most dynamic shared memory one H100 thread block may use (227 KB)
SMEM_BUDGET = 232448


def reset_counts() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
            PLAIN_CALLS[k] = 0


def _count(counts: dict, name: str) -> None:
    with _count_lock:
        counts[name] += 1


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


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _on(t, device, dtype) -> torch.Tensor:
    return torch.as_tensor(t).to(device=device, dtype=dtype).contiguous()


def _check_operands(name: str, device, *operands) -> None:
    """``operands``: (label, tensor, dtype, shape) of a packed call site."""
    for what, t, dtype, shape in operands:
        _check(f"{name} {what}", t, dtype, shape, device)


# ---------------------------------------------------------------------------
# K1: int8 matmul + requant


@dataclasses.dataclass
class MatmulRequant:
    """Packed operands of one :func:`matmul_int8_requant` call site."""

    w: torch.Tensor  # [N, K] int8: the JAX [K, N] weight, transposed once
    scale: torch.Tensor  # [N] f32: s_in * s_w
    bias: torch.Tensor  # [N] f32
    wsum: torch.Tensor  # [N] int32
    zp_in: int
    inv_out: float  # f32(1.0 / s_out), the Pallas kernel's reciprocal
    zp_out: int
    lo: float
    hi: float
    out_f32: bool

    def __post_init__(self):
        N, K = self.w.shape
        _check_operands("matmul_int8_requant", self.w.device,
                        ("w", self.w, torch.int8, (N, K)),
                        ("scale", self.scale, torch.float32, (N,)),
                        ("bias", self.bias, torch.float32, (N,)),
                        ("wsum", self.wsum, torch.int32, (N,)))


def pack_matmul(w_nk, scale, bias, wsum, *, zp_in: int, s_out: float, zp_out: int,
                act: str = "none", out_f32: bool = False, device=None) -> MatmulRequant:
    """``w_nk``: ``[N, K]`` int8 (a pointwise conv's ``[O, I]`` weight).
    ``device=None`` means CUDA."""
    device = resolve_device(device)
    lo, hi = _ACT[act]
    return MatmulRequant(
        w=_on(w_nk, device, torch.int8),
        scale=_on(scale, device, torch.float32),
        bias=_on(bias, device, torch.float32),
        wsum=_on(wsum, device, torch.int32),
        zp_in=int(zp_in), inv_out=recip_host(s_out), zp_out=int(zp_out),
        lo=lo, hi=hi, out_f32=bool(out_f32),
    )


def matmul_int8_requant_plain(x: torch.Tensor, op: MatmulRequant) -> torch.Tensor:
    # float64 holds every int8 dot product of K <= 2^37 exactly
    acc = x.to(torch.float64) @ op.w.to(torch.float64).T
    acc = acc - op.zp_in * op.wsum.to(torch.float64)
    # f64 -> f32 rounds the integer to nearest even, like int32 -> f32
    f = fma_f32(acc.to(torch.float32), op.scale, op.bias)
    f = torch.clamp(f, op.lo, op.hi)
    if op.out_f32:
        return f
    # pallas_int8.py:63: round(f * (1.0 / s_out)) + zp_out
    q = torch.round(f * op.inv_out) + op.zp_out
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def matmul_int8_requant_packed(x: torch.Tensor, op: MatmulRequant) -> torch.Tensor:
    """``x [M, K]`` int8 -> ``[M, N]`` int8 (or f32 when ``op.out_f32``)."""
    name = "matmul_int8_requant"
    if not _route(x, name):
        return matmul_int8_requant_plain(x, op)
    N, K = op.w.shape
    M = x.shape[0]
    _check(name + " x", x, torch.int8, (M, K), op.w.device)
    out = torch.empty((M, N), dtype=torch.float32 if op.out_f32 else torch.int8,
                      device=x.device)
    err = _fn("dfq_matmul_int8_requant")(
        x.data_ptr(), op.w.data_ptr(), op.scale.data_ptr(), op.bias.data_ptr(),
        op.wsum.data_ptr(), out.data_ptr(), M, N, K, op.zp_in, op.inv_out,
        float(op.zp_out), op.lo, op.hi, int(op.out_f32), _stream())
    _raise_on(err, name)
    _count(LAUNCHES, name)
    return out


def matmul_int8_requant(x, w, scale, bias, wsum, *, zp_in: int, s_out: float,
                        zp_out: int, act: str = "none", out_f32: bool = False):
    """The JAX package's signature: ``x [M, K]`` int8, ``w [K, N]`` int8,
    per-column ``scale``/``bias`` f32 and ``wsum`` int32."""
    op = pack_matmul(torch.as_tensor(w).T, scale, bias, wsum, zp_in=zp_in, s_out=s_out,
                     zp_out=zp_out, act=act, out_f32=out_f32, device=x.device)
    return matmul_int8_requant_packed(x, op)


# ---------------------------------------------------------------------------
# K2: depthwise 3x3 (stride 1, pad 1) + requant


@dataclasses.dataclass
class Dw3x3Requant:
    """Packed operands of one :func:`dw3x3_int8_requant` call site."""

    taps: torch.Tensor  # [9, C] int8, HW-major
    scale: torch.Tensor  # [C] f32
    bias: torch.Tensor  # [C] f32
    zp_in: int
    inv_out: float
    zp_out: int
    lo: float
    hi: float
    out_f32: bool

    def __post_init__(self):
        C = self.taps.shape[1]
        _check_operands("dw3x3_int8_requant", self.taps.device,
                        ("taps", self.taps, torch.int8, (9, C)),
                        ("scale", self.scale, torch.float32, (C,)),
                        ("bias", self.bias, torch.float32, (C,)))


def pack_dw3x3(taps, scale, bias, *, zp_in: int, s_out: float, zp_out: int,
               act: str = "none", out_f32: bool = False, device=None) -> Dw3x3Requant:
    """``taps``: ``[9, C]`` int8, HW-major. ``device=None`` means CUDA."""
    device = resolve_device(device)
    lo, hi = _ACT[act]
    return Dw3x3Requant(
        taps=_on(taps, device, torch.int8),
        scale=_on(scale, device, torch.float32),
        bias=_on(bias, device, torch.float32),
        zp_in=int(zp_in), inv_out=recip_host(s_out), zp_out=int(zp_out),
        lo=lo, hi=hi, out_f32=bool(out_f32),
    )


def _dw3x3_acc(x_minus_zp: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """int32 9-tap MAC over an NHWC tensor already shifted by its zero
    point; the zero padding is the zero point in the int8 domain."""
    _, H, W, _ = x_minus_zp.shape
    xp = F.pad(x_minus_zp, (0, 0, 1, 1, 1, 1))
    taps = taps.to(torch.int32)
    acc = torch.zeros_like(x_minus_zp)
    for ky in range(3):
        for kx in range(3):
            acc += xp[:, ky:ky + H, kx:kx + W, :] * taps[ky * 3 + kx]
    return acc


def dw3x3_int8_requant_plain(x: torch.Tensor, op: Dw3x3Requant) -> torch.Tensor:
    acc = _dw3x3_acc(x.to(torch.int32) - op.zp_in, op.taps)
    # the Pallas MAC is f32 and exact below 2^24, as is this conversion
    f = torch.clamp(fma_f32(acc.to(torch.float32), op.scale, op.bias), op.lo, op.hi)
    if op.out_f32:
        return f
    # pallas_int8.py:277: round(f * (1.0 / s_out)) + zp_out
    q = torch.round(f * op.inv_out) + op.zp_out
    return torch.clamp(q, -128.0, 127.0).to(torch.int8)


def dw3x3_int8_requant_packed(x: torch.Tensor, op: Dw3x3Requant) -> torch.Tensor:
    """``x [N, H, W, C]`` int8 -> same shape, int8 (or f32)."""
    name = "dw3x3_int8_requant"
    if not _route(x, name):
        return dw3x3_int8_requant_plain(x, op)
    C = op.taps.shape[1]
    if x.dim() != 4:
        raise ValueError(f"{name}: expected NHWC input, got shape {tuple(x.shape)}")
    N, H, W, _ = x.shape
    _check(name + " x", x, torch.int8, (N, H, W, C), op.taps.device)
    out = torch.empty((N, H, W, C), dtype=torch.float32 if op.out_f32 else torch.int8,
                      device=x.device)
    err = _fn("dfq_dw3x3_int8_requant")(
        x.data_ptr(), op.taps.data_ptr(), op.scale.data_ptr(), op.bias.data_ptr(),
        out.data_ptr(), N, H, W, C, op.zp_in, op.inv_out, float(op.zp_out), op.lo,
        op.hi, int(op.out_f32), _stream())
    _raise_on(err, name)
    _count(LAUNCHES, name)
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


def _align16(v: int) -> int:
    return (v + 15) // 16 * 16


def _fused_block_layout(bh: int, W: int, C: int, E: int) -> Tuple[int, int, int]:
    """K3's shared memory, laid out here only and passed to the kernel:
    the staged input rows ``[bh+2][W][C]`` at 0, the expanded tile with
    its halo ``[bh+2][W+2][E]`` at ``off_e``, the depthwise output tile
    ``[bh][W][E]`` at ``off_d``; returns ``(off_e, off_d, total bytes)``."""
    off_e = _align16((bh + 2) * W * C)
    off_d = off_e + _align16((bh + 2) * (W + 2) * E)
    return off_e, off_d, off_d + _align16(bh * W * E)


def fused_block_smem(bh: int, W: int, C: int, E: int) -> int:
    """Shared memory (bytes) of one K3 thread block of ``bh`` rows."""
    return _fused_block_layout(bh, W, C, E)[2]


def fused_block_fits(H: int, W: int, C: int, E: int, C2: int) -> bool:
    """True when K3 takes the block: channel counts are multiples of 4
    (one 32-bit word of int8) and a one-row slab fits the shared-memory
    budget. The engine runs the block unfused otherwise."""
    return (C % 4 == 0 and E % 4 == 0 and C2 % 4 == 0
            and fused_block_smem(1, W, C, E) <= SMEM_BUDGET)


def fused_block_rows(H: int, W: int, C: int, E: int) -> int:
    """Output rows per thread block: slabs of at most 8 rows (more blocks
    in flight; the 2 halo rows cost (bh+2)/bh in recomputed expand work),
    evened out over H, then shrunk until the slab fits the budget."""
    n_h = -(-H // 8)
    bh = -(-H // n_h)
    while bh > 1 and fused_block_smem(bh, W, C, E) > SMEM_BUDGET:
        bh -= 1
    return bh


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
    # launch arguments by input (H, W), all but the pointers x, out and N
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
            ("ws2", self.ws2, i32, (C2,)))


def _pack_words(w: torch.Tensor) -> torch.Tensor:
    """``[K, N]`` int8 -> ``[K/4, N]`` int32 words of 4 consecutive k."""
    K, N = w.shape
    return (w.reshape(K // 4, 4, N).permute(0, 2, 1).contiguous()
            .view(torch.int32).reshape(K // 4, N))


def _unpack_words(words: torch.Tensor) -> torch.Tensor:
    K4, N = words.shape
    return words.contiguous().view(torch.int8).reshape(K4, N, 4).permute(0, 2, 1).reshape(4 * K4, N)


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
    return FusedBlock(
        w1=_pack_words(w1.to(torch.int8)).to(device), sc1=_on(scale1, device, torch.float32),
        b1=_on(bias1, device, torch.float32), ws1=_on(wsum1, device, torch.int32),
        wd=_on(wd, device, torch.int8), scd=_on(scale_d, device, torch.float32),
        bd=_on(bias_d, device, torch.float32),
        w2=_pack_words(w2.to(torch.int8)).to(device), sc2=_on(scale2, device, torch.float32),
        b2=_on(bias2, device, torch.float32), ws2=_on(wsum2, device, torch.int32),
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
            "ws2", "out")]
        + [(n, ctypes.c_int) for n in ("N", "H", "W", "C", "E", "C2", "bh")]
        + [(n, ctypes.c_int) for n in ("off_e", "off_d", "smem", "req_c1", "zp_x")]
        + [("ratio_c1", ctypes.c_float), ("zp_c1_128", ctypes.c_float), ("zp_c1", ctypes.c_int)]
        + [(n, ctypes.c_float) for n in ("r_e", "lo_e", "hi_e")] + [("zp_e", ctypes.c_int)]
        + [(n, ctypes.c_float) for n in ("r_d", "lo_d", "hi_d")] + [("zp_d", ctypes.c_int)]
        + [("res", ctypes.c_int), ("req_r", ctypes.c_int)]
        + [(n, ctypes.c_float) for n in (
            "ratio_r", "zp_r_128", "s_r", "c_r", "r_p", "zp_p_128", "s_p", "c_p")]
        + [("out_f32", ctypes.c_int), ("r_o", ctypes.c_float), ("zp_o_128", ctypes.c_float)]
    )


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry points: library source, return type, argument types
_SIGNATURES = {
    "dfq_matmul_int8_requant": (
        "matmul_int8_requant.cu", _I, [_P] * 6 + [_I] * 4 + [_F] * 4 + [_I, _P]),
    "dfq_dw3x3_int8_requant": (
        "dw3x3_int8_requant.cu", _I, [_P] * 5 + [_I] * 5 + [_F] * 4 + [_I, _P]),
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


def _fused_block_args(op: FusedBlock, H: int, W: int) -> _FusedBlockArgs:
    """The launch arguments of ``op`` at input size ``H x W`` but the
    pointers ``x``, ``out`` and the batch ``N``; built once per size."""
    a = op.launch_args.get((H, W))
    if a is not None:
        return a
    if not fused_block_fits(H, W, op.C, op.E, op.C2):
        raise ValueError(f"fused_block_int8: block {(H, W, op.C, op.E, op.C2)} does not fit")
    a = _FusedBlockArgs()
    for n in ("w1", "sc1", "b1", "ws1", "wd", "scd", "bd", "w2", "sc2", "b2", "ws2"):
        setattr(a, n, getattr(op, n).data_ptr())
    a.H, a.W, a.C, a.E, a.C2 = H, W, op.C, op.E, op.C2
    a.bh = fused_block_rows(H, W, op.C, op.E)
    a.off_e, a.off_d, a.smem = _fused_block_layout(a.bh, W, op.C, op.E)
    for n in ("req_c1", "zp_x", "ratio_c1", "zp_c1", "r_e", "lo_e", "hi_e", "zp_e",
              "r_d", "lo_d", "hi_d", "zp_d", "res", "req_r", "ratio_r", "s_r", "c_r",
              "r_p", "s_p", "c_p", "out_f32", "r_o"):
        setattr(a, n, getattr(op, n))
    a.zp_c1_128, a.zp_r_128 = float(op.zp_c1 + 128), float(op.zp_r + 128)
    a.zp_p_128, a.zp_o_128 = float(op.zp_p + 128), float(op.zp_o + 128)
    op.launch_args[(H, W)] = a
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
    a = _FusedBlockArgs.from_buffer_copy(_fused_block_args(op, H, W))
    a.x, a.out, a.N = x.data_ptr(), out.data_ptr(), N
    err = _fn("dfq_fused_block_int8")(ctypes.byref(a), _stream())
    _raise_on(err, name)
    _count(LAUNCHES, name)
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
