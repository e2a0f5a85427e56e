"""The glue convs' epilogue: an exact int8 conv's accumulator to its
output, in one CUDA pass (``csrc/conv_epilogue_int8.cu``).

The fused engine (:class:`~dfq_tpu_torch.engine.int8_fused.Int8FusedNet`)
computes each lowered conv that no kernel takes as an exact integer
product, on one of :func:`~dfq_tpu_torch.engine.int8.int8_conv`'s routes,
and then this epilogue: ``acc - zp_in * wsum`` in int32, ``f32(a) * comb +
bias`` as one FMA (or ``f32(a) * comb`` without a bias), and the quantize
onto the consumer's grid, or f32 where the output carries none.

The accumulator comes as its route leaves it: int32 NHWC with any
strides (the ``torch._int_mm`` routes' ``[M, Np]`` rows, sliced to the
output's channels), or the f32 (CPU: float64) conv output of the cuDNN
route, NCHW by its shape (channels-last in memory on the card), whose
values are exact integers. The kernel reads either through its strides;
the plain version turns the second into the first, as the route did
before.

It replaces no Pallas kernel (XLA fused this epilogue into its int8 conv on
the TPU). Its launches and plain runs are counted here, apart from the
three kernels' counts in :mod:`~dfq_tpu_torch.ops.cuda_int8`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from dfq_tpu_torch.device import resolve_device
from dfq_tpu_torch.ops import _build
from dfq_tpu_torch.ops.cuda_int8 import (
    H100_SMS,
    _aligned16,
    _launch_on,
    _on,
    _raise_on,
    _sm_count,
    _stream,
)
from dfq_tpu_torch.ops.rounding import fma_f32, quant_u8, recip_xla

# launches of the kernel, and runs of the plain version through the
# wrapper (a CPU tensor); plain integers, reset with reset_counts()
EPILOGUE_LAUNCHES = 0
EPILOGUE_PLAIN_CALLS = 0
_lock = threading.Lock()

SOURCE = "conv_epilogue_int8.cu"
# the kernel's threads a block, and channels a thread
EPI_THREADS = 256
EPI_GROUP = 16
# blocks per SM a grid-stride launch keeps in flight
EPI_BLOCKS_PER_SM = 4
# the kernel's codes of its variants (EpilogueArgs.variant)
EPI_VARIANTS = ("rows_vec", "rows")


def reset_counts() -> None:
    global EPILOGUE_LAUNCHES, EPILOGUE_PLAIN_CALLS
    with _lock:
        EPILOGUE_LAUNCHES = 0
        EPILOGUE_PLAIN_CALLS = 0


def _count(launch: bool) -> None:
    global EPILOGUE_LAUNCHES, EPILOGUE_PLAIN_CALLS
    with _lock:
        if launch:
            EPILOGUE_LAUNCHES += 1
        else:
            EPILOGUE_PLAIN_CALLS += 1


@dataclasses.dataclass
class ConvEpilogue:
    """Packed operands of one glue conv's epilogue (:func:`pack_conv_epilogue`)."""

    wsum: torch.Tensor  # [C] int32
    comb: torch.Tensor  # [C] f32: in_scale * w_scale
    bias: Optional[torch.Tensor]  # [C] f32, or None
    zp: int  # the input's zero point
    grid: Optional[Tuple[float, int]]  # (scale, zp) of the output, or None: f32
    zpw: torch.Tensor  # [C] int32: zp * wsum, for the kernel
    bias_k: torch.Tensor  # [C] f32: bias, or zeros, for the kernel
    # launch arguments by (shape, strides, dtype, alignment) of the
    # accumulator; read, never written, by a launch
    launch_args: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def channels(self) -> int:
        return self.wsum.shape[0]


def pack_conv_epilogue(wsum, comb, bias, *, zp: int, grid: Optional[Tuple[float, int]],
                       device=None) -> ConvEpilogue:
    """``wsum`` int32 ``[C]`` (the weights' sums a channel), ``comb`` f32
    ``[C]``, ``bias`` f32 ``[C]`` or None, ``zp`` the input's zero point,
    ``grid`` the output's ``(scale, zp)`` or None for f32. ``device=None``
    means CUDA."""
    device = resolve_device(device)
    wsum = _on(np.asarray(wsum), device, torch.int32)
    comb = _on(np.asarray(comb, np.float32), device, torch.float32)
    bias = None if bias is None else _on(np.asarray(bias, np.float32), device, torch.float32)
    return ConvEpilogue(
        wsum=wsum, comb=comb, bias=bias, zp=int(zp),
        grid=None if grid is None else (float(grid[0]), int(grid[1])),
        zpw=(int(zp) * wsum).contiguous(),
        bias_k=torch.zeros_like(comb) if bias is None else bias)


def conv_epilogue_plain(acc: torch.Tensor, op: ConvEpilogue) -> torch.Tensor:
    """The torch epilogue, on any device: int32 NHWC ``acc``, or a float
    conv's NCHW output -> NHWC int8 codes on ``op.grid`` (f32 without one)."""
    if acc.is_floating_point():
        acc = acc.to(torch.int32).permute(0, 2, 3, 1).contiguous()
    a = (acc - op.zp * op.wsum).to(torch.float32)
    # f32(acc) * comb + bias: one FMA under XLA:CPU
    out = a * op.comb if op.bias is None else fma_f32(a, op.comb, op.bias)
    if op.grid is None:
        return out
    # round(x / scale): XLA multiplies by f32(1 / f32(scale))
    return quant_u8(out, recip_xla(op.grid[0]), op.grid[1])


@dataclasses.dataclass(frozen=True)
class EpiloguePlan:
    """How one call is launched: the variant (``"rows_vec"`` or
    ``"rows"``), the block (``(tx, ty)``: channel groups by pixels) and
    the grid."""

    variant: str
    block: Tuple[int, int]
    grid: Tuple[int, int]


def conv_epilogue_plan(B: int, H: int, W: int, C: int, strides: Tuple[int, int, int, int],
                       aligned: bool = True, sms: int = H100_SMS) -> EpiloguePlan:
    """The launch of an epilogue over a logical ``[B, H, W, C]``
    accumulator of element ``strides`` (batch, row, pixel, channel):

    - ``"rows_vec"`` where the channels are contiguous and every row of
      them starts on a 16-byte boundary (``aligned``: the base and the
      output; row strides multiples of 4 elements; C a multiple of 4): a
      thread a group of ``EPI_GROUP`` channels, as many pixels a block as
      fill ``EPI_THREADS`` threads;
    - ``"rows"`` otherwise (ragged or unaligned rows, any strides, an
      NCHW conv output), one element a load.

    A grid-stride grid keeps ``EPI_BLOCKS_PER_SM`` blocks an SM."""
    sb, sh, sw, sc = strides
    cap = sms * EPI_BLOCKS_PER_SM
    vec = sc == 1 and aligned and C % 4 == 0 and sb % 4 == 0 and sh % 4 == 0 and sw % 4 == 0
    groups = -(-C // EPI_GROUP)
    tx = min(groups, EPI_THREADS)
    ty = EPI_THREADS // tx
    gy = -(-groups // tx)
    return EpiloguePlan("rows_vec" if vec else "rows", (tx, ty),
                        (max(1, min(-(-B * H * W // ty), cap // gy)), gy))


class _EpilogueArgs(ctypes.Structure):
    """Layout of ``EpilogueArgs`` in ``csrc/conv_epilogue_int8.cu``."""

    _fields_ = (
        [(n, ctypes.c_void_p) for n in ("zpw", "comb", "bias")]
        + [(n, ctypes.c_longlong) for n in ("sb", "sh", "sw", "sc")]
        + [(n, ctypes.c_int) for n in ("B", "H", "W", "C")]
        + [(n, ctypes.c_float) for n in ("r_out", "zp128")]
        + [(n, ctypes.c_int) for n in ("has_bias", "in_f32", "out_f32", "variant", "tx", "ty",
                                        "grid_x", "grid_y")]
    )


# the C entry point's parameters: the arguments, acc, out and the stream
_ARGTYPES = [ctypes.POINTER(_EpilogueArgs)] + [ctypes.c_void_p] * 3
_FN = []


def _fn():
    """The C entry point, its types declared (built and loaded at first use)."""
    if not _FN:
        fn = _build.library(SOURCE).dfq_conv_epilogue
        fn.restype, fn.argtypes = ctypes.c_int, _ARGTYPES
        _FN.append(fn)
    return _FN[0]


def _nhwc_view(acc: torch.Tensor, C: int) -> torch.Tensor:
    """``acc`` as a logical NHWC view: int32 as it is, a float conv's
    output permuted from NCHW; raises on what the kernel does not take."""
    if acc.dim() != 4:
        raise ValueError(f"conv_epilogue: expected a 4-d accumulator, got {tuple(acc.shape)}")
    if acc.dtype == torch.float32:
        acc = acc.permute(0, 2, 3, 1)
    elif acc.dtype != torch.int32:
        raise TypeError(f"conv_epilogue: expected int32 or float32, got {acc.dtype}")
    if acc.shape[3] != C:
        raise ValueError(f"conv_epilogue: expected {C} channels, got {acc.shape[3]}")
    return acc


def _epilogue_args(op: ConvEpilogue, v: torch.Tensor, aligned: bool) -> _EpilogueArgs:
    """The launch arguments of ``op`` on the NHWC view ``v``; built once
    per (shape, strides, dtype, alignment)."""
    B, H, W, C = v.shape
    plan = conv_epilogue_plan(B, H, W, C, v.stride(), aligned, _sm_count(v.device))
    a = _EpilogueArgs()
    a.zpw, a.comb, a.bias = (t.data_ptr() for t in (op.zpw, op.comb, op.bias_k))
    a.sb, a.sh, a.sw, a.sc = v.stride()
    a.B, a.H, a.W, a.C = B, H, W, C
    s_out, zp_out = op.grid or (1.0, 0)
    a.r_out, a.zp128 = recip_xla(s_out), float(zp_out + 128)
    a.has_bias, a.in_f32 = int(op.bias is not None), int(v.is_floating_point())
    a.out_f32 = int(op.grid is None)
    a.variant = EPI_VARIANTS.index(plan.variant)
    (a.tx, a.ty), (a.grid_x, a.grid_y) = plan.block, plan.grid
    return a


def conv_epilogue_packed(acc: torch.Tensor, op: ConvEpilogue) -> torch.Tensor:
    """``acc`` (module docstring) -> ``[B, H, W, C]`` int8 codes on
    ``op.grid``, or f32 without one; the plain version for a CPU tensor."""
    if acc.device.type == "cpu":
        _count(False)
        return conv_epilogue_plain(acc, op)
    if acc.device.type != "cuda":
        raise ValueError(f"conv_epilogue: no kernel for device {acc.device}")
    if acc.device != op.zpw.device:
        raise ValueError(f"conv_epilogue: expected device {op.zpw.device}, got {acc.device}")
    v = _nhwc_view(acc, op.channels)
    out = torch.empty(v.shape, dtype=torch.int8 if op.grid else torch.float32,
                      device=acc.device)
    key = (v.shape, v.stride(), v.dtype, _aligned16(v, out))
    a = op.launch_args.get(key)
    if a is None:
        a = op.launch_args[key] = _epilogue_args(op, v, key[3])
    # the tensors' pointers go with the call, so serving threads may launch
    # the same site at once on the shared arguments
    with _launch_on(acc.device):
        err = _fn()(ctypes.byref(a), v.data_ptr(), out.data_ptr(), _stream(acc.device))
    _raise_on(err, "conv_epilogue")
    _count(True)
    return out
