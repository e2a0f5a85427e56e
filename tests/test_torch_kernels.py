"""The port's kernel plain versions vs the Pallas kernels in interpret mode.

Each of the three CUDA kernels of ``dfq_tpu_torch/ops/cuda_int8.py`` has a
plain PyTorch version, which a CPU tensor runs. It must be bit-exact with
the JAX package's Pallas kernel (run as the JAX suite runs it on the
CPU: jitted, in interpret mode) on int8 and f32 outputs alike, on the
same inputs made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dfq_tpu.ops import pallas_int8 as pk
from dfq_tpu_torch.ops import cuda_int8 as ck

torch.set_num_threads(1)


def _mm_inputs(rng, M, K, N):
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (K, N)).astype(np.int8)
    scale = rng.uniform(1e-4, 2e-3, N).astype(np.float32)
    bias = rng.normal(0, 1, N).astype(np.float32)
    wsum = w.astype(np.int32).sum(0)
    return x, w, scale, bias, wsum


@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("act", ["none", "relu", "relu6"])
@pytest.mark.parametrize("shape", [(70, 48, 40), (301, 27, 19), (64, 1280, 96)])
def test_matmul_int8_requant_bit_exact(shape, act, out_f32):
    rng = np.random.default_rng(sum(shape))
    M, K, N = shape
    x, w, scale, bias, wsum = _mm_inputs(rng, M, K, N)
    kw = dict(zp_in=-5, s_out=0.0371, zp_out=-20, act=act, out_f32=out_f32)
    ref = np.asarray(pk.matmul_int8_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(wsum), **kw))
    got = ck.matmul_int8_requant(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(bias), torch.from_numpy(wsum), **kw).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("shape", [(2, 12, 12, 32), (1, 9, 13, 20), (2, 7, 5, 6)])
def test_dw3x3_int8_requant_bit_exact(shape, out_f32):
    rng = np.random.default_rng(sum(shape))
    N, H, W, C = shape
    x = rng.integers(-128, 128, (N, H, W, C)).astype(np.int8)
    w = rng.integers(-128, 128, (9, C)).astype(np.int8)
    scale = rng.uniform(1e-4, 2e-3, C).astype(np.float32)
    bias = rng.normal(0, 1, C).astype(np.float32)
    kw = dict(zp_in=7, s_out=0.0193, zp_out=3, out_f32=out_f32)
    ref = np.asarray(pk.dw3x3_int8_requant(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), jnp.asarray(bias), **kw))
    got = ck.dw3x3_int8_requant(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(bias), **kw).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def _block_inputs(rng, C, E, C2):
    w1 = rng.integers(-128, 128, (C, E)).astype(np.int8)
    wd = rng.integers(-128, 128, (9, E)).astype(np.int8)
    w2 = rng.integers(-128, 128, (E, C2)).astype(np.int8)
    return dict(
        w1=w1, scale1=rng.uniform(1e-4, 5e-4, E).astype(np.float32),
        bias1=rng.normal(0, 0.5, E).astype(np.float32),
        wsum1=w1.astype(np.int32).sum(0),
        wd=wd, scale_d=rng.uniform(1e-3, 4e-3, E).astype(np.float32),
        bias_d=rng.normal(0, 0.5, E).astype(np.float32),
        w2=w2, scale2=rng.uniform(1e-5, 1e-4, C2).astype(np.float32),
        bias2=rng.normal(0, 0.5, C2).astype(np.float32),
        wsum2=w2.astype(np.int32).sum(0),
    )


_ARGS = ("w1", "scale1", "bias1", "wsum1", "wd", "scale_d", "bias_d",
         "w2", "scale2", "bias2", "wsum2")


@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("x_is_c1", [True, False])
@pytest.mark.parametrize("res", [True, False])
def test_fused_block_int8_bit_exact(res, x_is_c1, out_f32):
    rng = np.random.default_rng(3)
    N, H, W, C, E = 2, 10, 10, 24, 144
    C2 = C if res else 32
    x = rng.integers(-128, 128, (N, H, W, C)).astype(np.int8)
    ops = _block_inputs(rng, C, E, C2)
    x_grid = (0.0412, -9)
    grids = dict(
        x_grid=x_grid,
        c1_grid=x_grid if x_is_c1 else (0.0377, 4),
        e_grid=(0.0213, -128), d_grid=(0.0531, -128),
        act1_hi=3.4e38, act2_hi=6.0,
        res_grid=(0.0450, -2) if res else None,
        p_grid=(0.0301, 5) if res else None,
        out_grid=None if out_f32 else (0.0622, -1),
    )
    ref = np.asarray(pk.fused_block_int8(
        jnp.asarray(x), *(ops[k] for k in _ARGS), **grids))
    got = ck.fused_block_int8(
        torch.from_numpy(x), *(torch.from_numpy(ops[k]) for k in _ARGS),
        **grids).numpy()
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_fused_block_fits_and_rows():
    # every fused MobileNetV2 block fits the H100 shared-memory budget
    for H, C, E in ((56, 24, 144), (28, 32, 192), (14, 64, 384), (14, 96, 576),
                    (7, 160, 960)):
        assert ck.fused_block_fits(H, H, C, E, C)
        bh = ck.fused_block_rows(H, H, C, E)
        assert 1 <= bh <= 8
        assert ck.fused_block_smem(bh, H, C, E) <= ck.SMEM_BUDGET
    assert ck.fused_block_rows(56, 56, 24, 144) == 8
    assert ck.fused_block_rows(7, 7, 160, 960) == 7
    # channels that are not whole 32-bit words go unfused
    assert not ck.fused_block_fits(14, 14, 6, 36, 6)


@pytest.mark.parametrize("bh,W,C,E", [(8, 56, 24, 144), (7, 7, 160, 960), (1, 13, 4, 12)])
def test_fused_block_layout_is_aligned_and_disjoint(bh, W, C, E):
    off_e, off_d, total = ck._fused_block_layout(bh, W, C, E)
    assert off_e % 16 == 0 and off_d % 16 == 0 and total % 16 == 0
    assert off_e >= (bh + 2) * W * C
    assert off_d - off_e >= (bh + 2) * (W + 2) * E
    assert total - off_d >= bh * W * E
    assert total == ck.fused_block_smem(bh, W, C, E)


def test_pack_defaults_to_cuda_and_checks_operands_once():
    rng = np.random.default_rng(0)
    _, w, scale, bias, wsum = _mm_inputs(rng, 8, 16, 8)
    kw = dict(zp_in=0, s_out=0.1, zp_out=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ck.pack_matmul(w.T, scale, bias, wsum, **kw)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ck.pack_dw3x3(w[:9], scale, bias, **kw)
    op = ck.pack_matmul(w.T, scale, bias, wsum, **kw, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        ck.MatmulRequant(**{**vars(op), "bias": op.bias[:4]})
    with pytest.raises(TypeError):
        ck.MatmulRequant(**{**vars(op), "wsum": op.wsum.long()})


def test_wrapper_routes_cpu_to_plain_and_counts():
    rng = np.random.default_rng(0)
    x, w, scale, bias, wsum = _mm_inputs(rng, 8, 16, 8)
    ck.reset_counts()
    ck.matmul_int8_requant(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale),
        torch.from_numpy(bias), torch.from_numpy(wsum), zp_in=0, s_out=0.1, zp_out=0)
    assert ck.PLAIN_CALLS["matmul_int8_requant"] == 1
    assert ck.LAUNCHES["matmul_int8_requant"] == 0


def _rounding_boundaries(s, good, bad, n):
    """f32 values f whose quantized value round(f * r) differs between the
    reciprocal ``good`` (the one the reference uses) and ``bad`` — at
    least one exists next to most half-integers k + 0.5 of the grid."""
    out = []
    k = 1
    while len(out) < n:
        f = np.float32((k + 0.5) * s)
        for _ in range(16):
            if np.rint(np.float32(f * np.float32(good))) != np.rint(np.float32(f * np.float32(bad))):
                out.append(f)
                break
            f = np.nextafter(f, np.float32(np.inf))
        k += 1
    return np.array(out, np.float32)


def test_matmul_reciprocal_form_reaches_the_output():
    """K1 quantizes with Python's 1.0 / s_out rounded once: with x = 0 the
    output is round(bias * r), and the biases sit where the other
    reciprocal would round differently."""
    from dfq_tpu_torch.ops.rounding import recip_host, recip_xla

    s_out, N, K = 0.0371, 64, 16
    bias = _rounding_boundaries(s_out, recip_host(s_out), recip_xla(s_out), N)
    x = np.zeros((8, K), np.int8)
    w = np.random.default_rng(0).integers(-128, 128, (K, N)).astype(np.int8)
    args = (np.ones(N, np.float32), bias, w.astype(np.int32).sum(0))
    kw = dict(zp_in=0, s_out=s_out, zp_out=-128)
    ref = np.asarray(pk.matmul_int8_requant(
        jnp.asarray(x), jnp.asarray(w), *(jnp.asarray(a) for a in args), **kw))
    got = ck.matmul_int8_requant(torch.from_numpy(x), torch.from_numpy(w),
                                 *(torch.from_numpy(a) for a in args), **kw).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("stage", ["e", "d", "o"])
def test_fused_block_reciprocal_forms_reach_the_output(stage):
    """K3 quantizes with XLA's f32(1/f32(s)) at the e, d and out grids.
    The input sits on its zero point and the biases upstream of the stage
    are so negative that the stage sees f = its own bias, crafted where
    the other reciprocal rounds differently; the stages after it pass the
    difference on to the output."""
    from dfq_tpu_torch.ops.rounding import recip_host, recip_xla

    rng = np.random.default_rng(4)
    N, H, W, C, E, C2 = 1, 6, 6, 8, 64, 16
    grids = dict(x_grid=(0.0377, 5), c1_grid=(0.0377, 5), e_grid=(0.0213, -128),
                 d_grid=(0.0193, -128), act1_hi=3.4e38, act2_hi=3.4e38,
                 out_grid=(0.0371, -128) if stage == "o" else None)
    ops = _block_inputs(rng, C, E, C2)
    s = {"e": 0.0213, "d": 0.0193, "o": 0.0371}[stage]
    n = {"e": E, "d": E, "o": C2}[stage]
    crafted = _rounding_boundaries(s, recip_xla(s), recip_host(s), n)
    neg_e, neg_c2 = np.full(E, -1e3, np.float32), np.full(C2, -1e3, np.float32)
    ops["bias1"] = crafted if stage == "e" else neg_e
    ops["bias_d"] = {"e": ops["bias_d"], "d": crafted, "o": neg_e}[stage]
    ops["bias2"] = crafted if stage == "o" else ops["bias2"]
    if stage == "e":  # x on the zero point: the expand sees a1 = 0, f1 = bias1
        ops["scale1"] = np.ones(E, np.float32)
    x = np.full((N, H, W, C), 5, np.int8)
    ref = np.asarray(pk.fused_block_int8(jnp.asarray(x), *(ops[k] for k in _ARGS), **grids))
    got = ck.fused_block_int8(torch.from_numpy(x), *(torch.from_numpy(ops[k]) for k in _ARGS),
                              **grids).numpy()
    np.testing.assert_array_equal(got, ref)


# -- K2 at stride 2 against the engine's glue conv step ------------------------

def _glue_conv_step(x, qw, comb, bias, zp_in, s_out, zp_out):
    """The fused engine's step for a conv that no kernel takes
    (``Int8FusedNet._build_layer``'s ``conv`` step; the JAX engine's route
    for the stride-2 depthwise convs): ``int8_conv``'s exact product,
    ``acc - zp * wsum`` cast to f32, one FMA with the combined scale and the
    bias (a multiply without a bias), and ``_emit``'s quantize."""
    from dfq_tpu_torch.engine.int8 import int8_conv, pack_int8_product
    from dfq_tpu_torch.engine.int8_fused import _quantize_f32
    from dfq_tpu_torch.graph.ir import Node
    from dfq_tpu_torch.ops.rounding import fma_f32

    C = qw.shape[0]
    node = Node("dw", "conv", ("x",), {
        "in_ch": C, "out_ch": C, "kernel": (3, 3), "stride": (2, 2), "padding": (1, 1),
        "dilation": (1, 1), "groups": C})
    acc = int8_conv(x, node, pack_int8_product(qw, node, x.device), zp_in)
    wsum = torch.from_numpy(qw.astype(np.int32).reshape(C, 9).sum(1))
    a = (acc - zp_in * wsum).to(torch.float32)
    comb_t = torch.from_numpy(comb)
    out = a * comb_t if bias is None else fma_f32(a, comb_t, torch.from_numpy(bias))
    return _quantize_f32(out, s_out, zp_out)


def _dw_s2_op(qw, comb, bias, zp_in, s_out, zp_out):
    C = qw.shape[0]
    return ck.pack_dw3x3(qw.reshape(C, 9).T, comb,
                         np.zeros(C, np.float32) if bias is None else bias,
                         zp_in=zp_in, s_out=s_out, zp_out=zp_out, stride=2, device="cpu")


@pytest.mark.parametrize("zp_in", [-128, 0, 127])
@pytest.mark.parametrize("C", [96, 64, 6])
@pytest.mark.parametrize("hw", [(112, 112), (75, 75), (19, 19), (3, 3), (2, 2), (3, 75)],
                         ids=lambda s: "x".join(map(str, s)))
def test_dw3x3_s2_plain_equals_the_glue_conv_step(hw, C, zp_in):
    """K2's stride-2 plain version equals, bit for bit, the glue's conv
    step at a stride-2 depthwise conv (odd sizes 75 -> 38, 19 -> 10, 3 -> 2, a map
    narrower than a strip, channels that are not whole words, the zero
    point at both ends of the grid; without a bias at zp_in 0)."""
    H, W = hw
    rng = np.random.default_rng(H * W + C + zp_in + 128)
    N = 1 if H * W > 5000 else 2
    x = torch.from_numpy(rng.integers(-128, 128, (N, H, W, C)).astype(np.int8))
    qw = rng.integers(-128, 128, (C, 1, 3, 3)).astype(np.int8)
    comb = rng.uniform(1e-4, 2e-3, C).astype(np.float32)
    bias = None if zp_in == 0 else rng.normal(0, 1, C).astype(np.float32)
    s_out, zp_out = 0.0193, -17
    want = _glue_conv_step(x, qw, comb, bias, zp_in, s_out, zp_out)
    op = _dw_s2_op(qw, comb, bias, zp_in, s_out, zp_out)
    ck.reset_counts()
    got = ck.dw3x3_int8_requant_packed(x, op)
    assert ck.PLAIN_CALLS["dw3x3_int8_requant"] == 1
    assert got.dtype == want.dtype == torch.int8 and got.shape == (N, -(-H // 2), -(-W // 2), C)
    assert torch.equal(got, want)
    assert torch.equal(ck.dw3x3_int8_requant_strip_plain(x, op), want)


def test_dw3x3_s2_reciprocal_form_reaches_the_output():
    """K2 at stride 2 quantizes with the glue's f32(1/f32(s)), not with
    stride 1's f32(1.0 / s): with x on its zero point the output is
    quant(bias), and the biases sit where the two reciprocals round
    apart."""
    from dfq_tpu_torch.ops.rounding import recip_host, recip_xla

    s_out, C, zp_in = 0.0371, 64, 9
    bias = _rounding_boundaries(s_out, recip_xla(s_out), recip_host(s_out), C)
    qw = np.random.default_rng(0).integers(-128, 128, (C, 1, 3, 3)).astype(np.int8)
    comb = np.ones(C, np.float32)
    x = torch.full((1, 7, 7, C), zp_in, dtype=torch.int8)
    want = _glue_conv_step(x, qw, comb, bias, zp_in, s_out, -128)
    got = ck.dw3x3_int8_requant_packed(x, _dw_s2_op(qw, comb, bias, zp_in, s_out, -128))
    assert torch.equal(got, want)
    host = torch.from_numpy(np.rint(bias * np.float32(recip_host(s_out)))) - 128
    assert not torch.equal(got[0, 0, 0].to(torch.float32), host.clamp(-128, 127))


def test_pack_dw3x3_refuses_what_stride_2_does_not_take():
    rng = np.random.default_rng(0)
    args = (rng.integers(-128, 128, (9, 8)).astype(np.int8), np.ones(8, np.float32),
            np.zeros(8, np.float32))
    kw = dict(zp_in=0, s_out=0.1, zp_out=0, device="cpu")
    with pytest.raises(ValueError, match="stride 3"):
        ck.pack_dw3x3(*args, stride=3, **kw)
    for extra in (dict(act="relu"), dict(out_f32=True)):
        with pytest.raises(ValueError, match="stride 2"):
            ck.pack_dw3x3(*args, stride=2, **extra, **kw)
