"""dfq_tpu_torch — the PyTorch and CUDA port of ``dfq_tpu``.

A second package beside the JAX one, for NVIDIA Hopper (H100): the same
graph IR, data-free quantization passes and int8 lowering (host numpy,
equal to ``dfq_tpu``'s), and the fused int8 engine as an ``nn.Module``
whose hot path runs on hand-written CUDA kernels (``ops/cuda_int8.py``,
sources in ``csrc/``). It imports neither ``jax`` nor ``dfq_tpu``; the
tests hold it against both. Entry points run on the card unless the
caller asks for the CPU.
"""

__version__ = "0.1.0"
