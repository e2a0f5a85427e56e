"""Pin, on the installed JAX, the XLA:CPU floating-point forms that the
port mirrors to be bit-exact with the JAX package.

The port's rounding helpers live in ``dfq_tpu_torch/ops/rounding.py``
(``recip_xla``, ``recip_host``, ``fma_f32``, ``mean_quant_recip``) and the
CUDA kernels' ``csrc/int8_epilogue.cuh``. If a JAX/XLA upgrade changes one
of these forms, the test here fails with a message pointing there, rather
than as scattered one-LSB failures of the parity tests.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dfq_tpu.ops import pallas_int8 as pk
from dfq_tpu_torch.ops.rounding import fma_f32, mean_quant_recip, recip_host, recip_xla

torch.set_num_threads(1)

HELPERS = "dfq_tpu_torch/ops/rounding.py and dfq_tpu_torch/csrc/int8_epilogue.cuh"


def test_divide_by_constant_is_reciprocal_multiply():
    rng = np.random.default_rng(0)
    v = rng.normal(0, 50, 1 << 20).astype(np.float32)
    c = 0.0371
    got = np.asarray(jax.jit(lambda t: t / c)(jnp.asarray(v)))
    mirrored = v * np.float32(recip_xla(c))
    true_div = v / np.float32(c)
    assert np.array_equal(got, mirrored), (
        "XLA no longer compiles `x / c` as x * f32(1/f32(c)): update recip_xla "
        f"and its call sites ({HELPERS})")
    assert not np.array_equal(got, true_div)  # the form is observable
    # the Pallas K1/K2 reciprocal (Python's 1.0 / s) is a different constant
    s = rng.uniform(0.001, 0.1, 256)
    assert any(recip_host(x) != recip_xla(x) for x in s)


def test_k1_interpret_epilogue_is_fma():
    rng = np.random.default_rng(1)
    M, K, N = 4096, 96, 256
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    scale = rng.uniform(1e-4, 2e-3, N).astype(np.float32)
    bias = rng.normal(0, 1, N).astype(np.float32)
    wsum = w.astype(np.int32).sum(0)
    got = np.asarray(pk.matmul_int8_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(wsum), zp_in=3, s_out=1.0, zp_out=0, out_f32=True))
    acc = (x.astype(np.int64) @ w.astype(np.int64) - 3 * wsum).astype(np.float32)
    fma = fma_f32(torch.from_numpy(acc), torch.from_numpy(scale),
                  torch.from_numpy(bias)).numpy()
    two_roundings = acc * scale + bias
    assert np.array_equal(got, fma), (
        "the Pallas K1 epilogue f32(acc) * scale + bias is no longer one FMA "
        f"under XLA:CPU: update fma_f32 / dequant_fma ({HELPERS})")
    assert not np.array_equal(got, two_roundings)


def test_requant_multiply_add_is_fma():
    rng = np.random.default_rng(2)
    q = rng.integers(-128, 128, 1 << 20).astype(np.int8)
    zp, ratio, zp2 = -7, 0.0371234 / 0.0519876, 11
    got = np.asarray(jax.jit(
        lambda t: (t.astype(jnp.float32) - zp) * ratio + (zp2 + 128))(jnp.asarray(q)))
    a = torch.from_numpy(q.astype(np.float32) - np.float32(zp))
    fma = fma_f32(a, float(np.float32(ratio)), float(zp2 + 128)).numpy()
    assert np.array_equal(got, fma), (
        f"the grid-to-grid requant is no longer one FMA under XLA:CPU ({HELPERS})")


def test_mean_then_quantize_folds_reciprocals():
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (64, 7, 7, 32)).astype(np.float32)
    for s in rng.uniform(0.001, 0.1, 8):
        s = float(s)
        fn = jax.jit(lambda t: jnp.round(jnp.mean(t, axis=(1, 2)) / s))
        consts = {np.float32(float(c)) for c in re.findall(
            r"f32\[\] constant\(([-0-9.e+]+)\)", fn.lower(jnp.asarray(x)).compile().as_text())}
        assert np.float32(mean_quant_recip(49, s)) in consts, (
            "XLA no longer folds mean's 1/n into the quantize reciprocal as "
            f"f32(f32(1/n) * f32(1/s)): update mean_quant_recip ({HELPERS})")
    # and the spatial sum is sequential over (h, w) in f32
    mean = np.asarray(jax.jit(lambda t: jnp.mean(t, axis=(1, 2)))(jnp.asarray(x)))
    acc = x[:, 0, 0].copy()
    for i in range(1, 49):
        acc = acc + x[:, i // 7, i % 7]
    assert np.array_equal(mean, acc * (np.float32(1) / np.float32(49))), (
        "XLA's spatial mean is no longer a sequential f32 sum times f32(1/n): "
        "update Int8FusedNet._build_mean")
