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
import pytest
import torch

from dfq_tpu.ops import pallas_int8 as pk
from dfq_tpu.quant import core as jcore
from dfq_tpu_torch.quant import core as tcore
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


def _with_ties(x, lo, hi, bits, symmetric):
    """``x`` plus inputs whose scaled value ``(x - offset) * f32(1/scale)``
    is exactly a half integer in f32 (round-half-to-even decides them)."""
    scale, offset, qmin, qmax = jcore.quant_params(lo, hi, bits, symmetric)
    s, o = np.float32(scale), np.float32(offset)
    r = np.float32(recip_xla(float(s)))
    k = np.arange(qmin, qmax, dtype=np.float32) + np.float32(0.5)
    cand = (o + k / r).astype(np.float32)
    cand = np.concatenate([np.nextafter(cand, np.float32(-np.inf)), cand,
                           np.nextafter(cand, np.float32(np.inf))])
    v = (cand - o) * r
    ties = cand[v == np.floor(v) + np.float32(0.5)]
    assert ties.size, "no exact ties found"
    return np.concatenate([x, ties]).astype(np.float32), ties.size


@pytest.mark.parametrize("bits", [4, 6, 8])
@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("lo,hi", [(-2.3718, 7.91234), (-5.0, 1.0), (0.0, 6.0)])
def test_fake_quant_is_the_jitted_form(lo, hi, bits, symmetric):
    """The port's ``fake_quant`` is bit-equal to ``jax.jit(fake_quant)``:
    ``(x - offset) * f32(1/scale)``, clip, round, and the dequant
    ``q * scale + offset`` as one FMA; ties included."""
    rng = np.random.default_rng(bits)
    x, n_ties = _with_ties(rng.normal(1.0, 4.0, 1 << 17).astype(np.float32),
                           lo, hi, bits, symmetric)
    want = np.asarray(jax.jit(lambda t: jcore.fake_quant(t, lo, hi, bits, symmetric))(
        jnp.asarray(x)))
    got = tcore.fake_quant(torch.from_numpy(x), lo, hi, bits, symmetric).numpy()
    bad = int((got != want).sum())
    assert bad == 0, (f"{bad} of {x.size} outputs ({n_ties} ties) differ from "
                      f"jax.jit(fake_quant): update quant/core.py:fake_quant")
    # the port's earlier form (true division, separate multiply and add) is
    # observably different on the asymmetric grids
    s, o, qmin, qmax = tcore.quant_params(lo, hi, bits, symmetric)
    old = (torch.round(torch.clamp((torch.from_numpy(x) - float(o)) / float(s), qmin, qmax))
           * np.float32(s) + np.float32(o)).numpy()
    if not symmetric and bits == 8:
        assert not np.array_equal(old, want)


@pytest.mark.parametrize("symmetric", [False, True])
def test_fake_quant_with_a_data_range_is_the_traced_form(symmetric):
    """A range computed from the data (the simulator's ``self_quant``) is a
    traced value under jit: f32 scale ``span * f32(1/qmax)``, true
    division, FMA dequant."""
    rng = np.random.default_rng(7)
    x = rng.normal(0.5, 3.0, 1 << 17).astype(np.float32)
    for lo, hi in ((-2.3718, 7.91234), (-5.0, 1.0)):
        for bits in (4, 8):
            want = np.asarray(jax.jit(
                lambda t, a, b: jcore.fake_quant(t, a, b, bits, symmetric))(
                jnp.asarray(x), jnp.float32(lo), jnp.float32(hi)))
            got = tcore.fake_quant(torch.from_numpy(x), torch.tensor(lo), torch.tensor(hi),
                                   bits, symmetric).numpy()
            assert np.array_equal(got, want), (lo, hi, bits, int((got != want).sum()))


@pytest.mark.parametrize("h,w", [(1, 1), (2, 2), (2, 3), (3, 3), (4, 4), (7, 7), (8, 5)])
def test_spatial_mean_of_a_fake_quant_is_xla_order(h, w):
    """``jnp.mean(fake_quant(x, 0, hi))`` over (h, w), the baseline engine's
    global mean, sums ``fma(q, s, acc)`` in XLA:CPU's order: in order over
    (h, w), but at heights 2, 4 and 8 a chain per row and the rows added
    as a halving tree (``Int8Net._build_mean``)."""
    from dfq_tpu_torch.engine.int8 import _spatial_sum

    rng = np.random.default_rng(h * 10 + w)
    s = np.float32(0.0237)
    x = rng.uniform(0, 260 * s, (2, h, w, 512)).astype(np.float32)
    hi = float(255 * s)
    want = np.asarray(jax.jit(lambda t: jnp.sum(jcore.fake_quant(t, 0.0, hi), axis=(1, 2)))(
        jnp.asarray(x)))
    scale = np.float32(hi / 255.0)
    q = torch.round(torch.clamp(torch.from_numpy(x) * recip_xla(float(scale)), 0.0, 255.0))
    got = _spatial_sum(q, float(scale)).numpy()
    bad = int((got != want).sum())
    assert bad == 0, f"{bad} of {want.size} sums differ from XLA's order: update _spatial_sum"
