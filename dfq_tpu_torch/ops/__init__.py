"""Hand-written CUDA kernels of the int8 hot path, with their plain
PyTorch versions (see :mod:`dfq_tpu_torch.ops.cuda_int8`, and
:mod:`dfq_tpu_torch.ops.conv_epilogue` for the glue convs' epilogue)."""

from dfq_tpu_torch.ops.cuda_int8 import (  # noqa: F401
    LAUNCHES,
    PLAIN_CALLS,
    dw3x3_int8_requant,
    fused_block_fits,
    fused_block_int8,
    matmul_int8_requant,
    reset_counts,
)
