"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda`` and skipped without a CUDA device (decided in a fixture,
not at import). On the GPU machine run ``python -m pytest
tests/test_torch_cuda.py -q``. Covers the kernel variants the MobileNetV2
main path of ``chip_smoke.py`` does not reach: ragged M/N/K and unaligned
K on K1, channel counts that are not a multiple of 4 on K2, f32 output
and both residual requants on K3, and the wrappers' argument checks.
"""

import numpy as np
import pytest
import torch

from dfq_tpu_torch.ops import cuda_int8 as ck

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _equal(got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("act", ["none", "relu", "relu6"])
@pytest.mark.parametrize("shape", [(70, 48, 40), (301, 27, 19), (129, 1280, 1000), (5, 3, 2)])
def test_matmul_kernel_equals_plain(dev, shape, act, out_f32):
    rng = np.random.default_rng(sum(shape))
    M, K, N = shape
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (N, K)).astype(np.int8)
    op = ck.pack_matmul(w, rng.uniform(1e-5, 2e-3, N).astype(np.float32),
                        rng.normal(0, 1, N).astype(np.float32),
                        w.astype(np.int32).sum(1), zp_in=-5, s_out=0.0371, zp_out=-20,
                        act=act, out_f32=out_f32, device=dev)
    xd = _t(x, dev)
    _equal(ck.matmul_int8_requant_packed(xd, op), ck.matmul_int8_requant_plain(xd, op))


@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("shape", [(2, 12, 12, 32), (1, 9, 13, 20), (2, 7, 5, 6)])
def test_dw3x3_kernel_equals_plain(dev, shape, out_f32):
    rng = np.random.default_rng(sum(shape))
    N, H, W, C = shape
    x = rng.integers(-128, 128, shape).astype(np.int8)
    op = ck.pack_dw3x3(rng.integers(-128, 128, (9, C)).astype(np.int8),
                       rng.uniform(1e-4, 2e-3, C).astype(np.float32),
                       rng.normal(0, 1, C).astype(np.float32),
                       zp_in=7, s_out=0.0193, zp_out=3, out_f32=out_f32, device=dev)
    xd = _t(x, dev)
    _equal(ck.dw3x3_int8_requant_packed(xd, op), ck.dw3x3_int8_requant_plain(xd, op))


@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("x_grid", [(0.0412, -9), (0.0450, -2)])
@pytest.mark.parametrize("res", [True, False])
@pytest.mark.parametrize("hw", [10, 13])
def test_fused_block_kernel_equals_plain(dev, hw, res, x_grid, out_f32):
    rng = np.random.default_rng(hw)
    N, C, E = 2, 24, 144
    C2 = C if res else 32
    x = rng.integers(-128, 128, (N, hw, hw, C)).astype(np.int8)
    w1 = rng.integers(-128, 128, (C, E)).astype(np.int8)
    w2 = rng.integers(-128, 128, (E, C2)).astype(np.int8)
    op = ck.pack_fused_block(
        w1, rng.uniform(1e-4, 5e-4, E).astype(np.float32),
        rng.normal(0, 0.5, E).astype(np.float32), w1.astype(np.int32).sum(0),
        rng.integers(-128, 128, (9, E)).astype(np.int8),
        rng.uniform(1e-3, 4e-3, E).astype(np.float32),
        rng.normal(0, 0.5, E).astype(np.float32),
        w2, rng.uniform(1e-5, 1e-4, C2).astype(np.float32),
        rng.normal(0, 0.5, C2).astype(np.float32), w2.astype(np.int32).sum(0),
        x_grid=x_grid, c1_grid=(0.0412, -9), e_grid=(0.0213, -128),
        d_grid=(0.0531, -128), act1_hi=3.4e38, act2_hi=6.0,
        res_grid=(0.0450, -2) if res else None, p_grid=(0.0301, 5) if res else None,
        out_grid=None if out_f32 else (0.0622, -1), device=dev)
    xd = _t(x, dev)
    _equal(ck.fused_block_int8_packed(xd, op), ck.fused_block_int8_plain(xd, op))


def test_wrappers_check_their_arguments(dev):
    rng = np.random.default_rng(0)
    w = rng.integers(-128, 128, (8, 16)).astype(np.int8)
    op = ck.pack_matmul(w, np.ones(8, np.float32), np.zeros(8, np.float32),
                        w.astype(np.int32).sum(1), zp_in=0, s_out=1.0, zp_out=0,
                        device=dev)
    x = torch.zeros((4, 16), dtype=torch.int8, device=dev)
    with pytest.raises(TypeError):
        ck.matmul_int8_requant_packed(x.float(), op)
    with pytest.raises(ValueError, match="shape"):
        ck.matmul_int8_requant_packed(x[:, :8], op)
    with pytest.raises(ValueError, match="contiguous"):
        ck.matmul_int8_requant_packed(torch.zeros((16, 4), dtype=torch.int8,
                                                  device=dev).t(), op)
    cpu_op = ck.pack_matmul(w, np.ones(8, np.float32), np.zeros(8, np.float32),
                            w.astype(np.int32).sum(1), zp_in=0, s_out=1.0, zp_out=0,
                            device="cpu")
    with pytest.raises(ValueError, match="device"):
        ck.matmul_int8_requant_packed(x, cpu_op)
