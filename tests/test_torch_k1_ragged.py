"""K1 at the shapes only its dp4a variant took before the tensor-core
variants took them: N not a multiple of 8 (SSD-Lite's class heads,
N = 126; DeepLab's classifier, N = 21) and K past ~1.8k (2048: the
DeepLab backbones; 9216: AlexNet's classifier). The packed operands pad N to a multiple of 8 with
zero weight rows and zero scale, bias and wsum, as the Pallas wrapper
pads it; the plain version of the padded pack computes the real columns
only, and must be bit-equal to ``dfq_tpu.ops.pallas_int8`` in interpret
mode on the same inputs, made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dfq_tpu.ops import pallas_int8 as pk
from dfq_tpu_torch.ops import cuda_int8 as ck

torch.set_num_threads(1)

# (M, K): K = 9216 only at M <= 8, which keeps interpret mode to seconds
_MK = [(1, 2048), (8, 2048), (37, 2048), (1, 9216), (8, 9216)]


@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("N", [21, 126])
@pytest.mark.parametrize("M,K", _MK)
def test_padded_pack_plain_equals_pallas(M, K, N, out_f32):
    rng = np.random.default_rng(M + K + N)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    scale = rng.uniform(1e-6, 2e-5, N).astype(np.float32)
    bias = rng.normal(0, 1, N).astype(np.float32)
    wsum = w.astype(np.int32).sum(0)
    kw = dict(zp_in=-7, s_out=0.0371, zp_out=-20, act="relu", out_f32=out_f32)
    ref = np.asarray(pk.matmul_int8_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(wsum), **kw))
    op = ck.pack_matmul(w.T, scale, bias, wsum, zp_in=-7, s_out=0.0371, zp_out=-20,
                        act="relu", out_f32=out_f32, device="cpu")
    Np = -(-N // 8) * 8
    assert op.n_out == N and tuple(op.w.shape) == (Np, K)
    assert not op.w[N:].any() and not op.scale[N:].any() and not op.bias[N:].any()
    assert not op.wsum[N:].any()
    got = ck.matmul_int8_requant_packed(torch.from_numpy(x), op).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape == (M, N)
    np.testing.assert_array_equal(got, ref)
    # the card runs these on the tensor cores: the streamed variant (K past
    # a whole-K tile), split over K at these few rows
    plan = ck.matmul_plan(M, K, N, out_f32)
    assert plan.variant == "stream" and plan.grid[2] > 1


def test_pack_pads_n_and_keeps_multiples_of_8():
    rng = np.random.default_rng(0)
    w = rng.integers(-128, 128, (40, 16)).astype(np.int8)  # [N, K]
    op = ck.pack_matmul(w, np.ones(40, np.float32), np.zeros(40, np.float32),
                        w.astype(np.int32).sum(1), zp_in=0, s_out=0.1, zp_out=0, device="cpu")
    assert op.n_out == 40 and tuple(op.w.shape) == (40, 16)  # nothing to pad
    with pytest.raises(ValueError, match="multiple of 8"):
        ck.MatmulRequant(**{**vars(op), "n_out": 32})
