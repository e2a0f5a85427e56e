"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda`` and skipped without a CUDA device (decided in a fixture,
not at import). On the GPU machine run ``python -m pytest
tests/test_torch_cuda.py -q``. Covers the kernel variants the MobileNetV2
main path of ``chip_smoke.py`` does not reach: ragged K and unaligned
operands on K1 (its dp4a variant), ragged N on its resident tensor-core
variant, long K, ragged N and batch-row GEMVs split over K on its
streamed variant (two runs bit-equal), its resident variant at every main-path
(K, N) with a ragged last tile and with more tiles than blocks, channel
counts that are not a multiple of 4 on K2 (its general variant), its
strip variant with ragged strips and slabs and extreme zero points, its
stride-2 variants (strip and general) at every stride-2 site of
MobileNetV2 224x224 and SSD-Lite 300x300 at batch 1, 8 and 128 and both
models' b128 forwards bit-equal to the same nets with those convs on the
glue route, f32
output and both residual requants on K3, both K3 variants at the real
channel counts of its 7 main-path shape classes on small and ragged
images, the wrappers' argument checks, the SSD-Lite and DeepLab shapes
(K1's resident variant at the class heads and the segmentation
classifier, N not a multiple of 8, K2 and K3 at the detection sites, the dilated ASPP, decoder
and unpadded depthwise convs), calibration's distillation loss and
gradient and ``calibrate_ranges`` on the card against the CPU, the
sharded fused forward at 3 and 4 shards on one card, and each wrapper
launching on its input's device and stream, and the fused engine's conv
rewrites (shift9, im2col, batch-to-space, channel padding, dense-diagonal
depthwise, the s2d stem) bit-equal to ``int8_conv`` at SSD-Lite's and
DeepLab's shapes, and the glue convs' epilogue kernel
(``ops/conv_epilogue.py``) bit-equal to its plain version in each of its
variants, on the current stream and in a CUDA graph, and at every glue
conv site of the four benchmark cells' configurations, one launch a glue
``conv`` step, and the fused forward replayed as a CUDA graph on those
four configurations at b8, b3 and the cell's batch (bit-equal to the
step-by-step forward, a result untouched by a later call, the wrapper
launches of the first forward one a site and of a replay its suffix's),
from two threads on two streams, captured on a thread new to the net and
beside another net's forwards on a second thread, and under a profiler
on the four at the cell's batch (each kernel of a replay traced, one a
site).
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


# every (K, N) of the MobileNetV2 main path
_MAIN_KN = [(32, 16), (16, 96), (96, 24), (24, 144), (144, 32), (32, 192), (192, 64),
            (96, 576), (576, 160), (320, 1280), (1280, 1000)]


def _mm_case(dev, M, K, N, act, out_f32, variant):
    rng = np.random.default_rng(M + K + N)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (N, K)).astype(np.int8)
    op = ck.pack_matmul(w, rng.uniform(1e-5, 2e-3, N).astype(np.float32),
                        rng.normal(0, 1, N).astype(np.float32),
                        w.astype(np.int32).sum(1), zp_in=-5, s_out=0.0371, zp_out=-20,
                        act=act, out_f32=out_f32, device=dev)
    xd = _t(x, dev)
    ck.reset_counts()
    got = ck.matmul_int8_requant_packed(xd, op)
    assert ck.VARIANTS["matmul_int8_requant"][variant] == 1
    _equal(got, ck.matmul_int8_requant_plain(xd, op))


@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("act", ["none", "relu", "relu6"])
@pytest.mark.parametrize("kn", _MAIN_KN, ids=lambda kn: f"{kn[0]}x{kn[1]}")
def test_matmul_mma_variant_ragged_last_tile(dev, kn, act, out_f32):
    _mm_case(dev, 777, kn[0], kn[1], act, out_f32, "mma")


@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("act", ["none", "relu", "relu6"])
def test_matmul_mma_variant_more_tiles_than_blocks(dev, act, out_f32):
    _mm_case(dev, 200001, 16, 96, act, out_f32, "mma")


@pytest.mark.parametrize("shape,variant", [((70, 48, 40), "mma"), ((301, 27, 19), "dp4a"),
                                           ((5, 3, 2), "dp4a"), ((1, 8, 8), "mma")])
def test_matmul_variant_follows_the_shape(dev, shape, variant):
    _mm_case(dev, *shape, "none", False, variant)


def test_matmul_unaligned_input_takes_the_dp4a_variant(dev):
    rng = np.random.default_rng(5)
    w = rng.integers(-128, 128, (40, 48)).astype(np.int8)
    op = ck.pack_matmul(w, rng.uniform(1e-5, 2e-3, 40).astype(np.float32),
                        rng.normal(0, 1, 40).astype(np.float32), w.astype(np.int32).sum(1),
                        zp_in=3, s_out=0.0371, zp_out=-20, device=dev)
    # rows 1.. of a [71, 48] buffer: contiguous, 48 bytes off the allocation
    xd = _t(rng.integers(-128, 128, (71, 48)).astype(np.int8), dev)[1:]
    assert xd.is_contiguous() and xd.data_ptr() % 16 == 0
    xo = _t(rng.integers(-128, 128, (70 * 48 + 4,)).astype(np.int8), dev)[4:].view(70, 48)
    assert xo.data_ptr() % 16 == 4
    ck.reset_counts()
    for x, variant in ((xd, "mma"), (xo, "dp4a")):
        got = ck.matmul_int8_requant_packed(x, op)
        assert ck.VARIANTS["matmul_int8_requant"][variant] == 1
        _equal(got, ck.matmul_int8_requant_plain(x, op))


@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("zp_in", [-128, 127])
@pytest.mark.parametrize("shape", [(2, 9, 13, 32), (1, 1, 10, 32), (2, 12, 11, 96),
                                   (3, 17, 4, 32), (1, 8, 3, 96)])
def test_dw3x3_strip_variant_equals_plain(dev, shape, zp_in, out_f32):
    rng = np.random.default_rng(sum(shape))
    C = shape[-1]
    x = rng.integers(-128, 128, shape).astype(np.int8)
    op = ck.pack_dw3x3(rng.integers(-128, 128, (9, C)).astype(np.int8),
                       rng.uniform(1e-4, 2e-3, C).astype(np.float32),
                       rng.normal(0, 1, C).astype(np.float32),
                       zp_in=zp_in, s_out=0.0193, zp_out=3, out_f32=out_f32, device=dev)
    xd = _t(x, dev)
    ck.reset_counts()
    got = ck.dw3x3_int8_requant_packed(xd, op)
    assert ck.VARIANTS["dw3x3_int8_requant"] == {"strip": 1, "general": 0, "strip_s2": 0,
                                                 "general_s2": 0}
    _equal(got, ck.dw3x3_int8_requant_plain(xd, op))
    _equal(got, ck.dw3x3_int8_requant_strip_plain(xd, op))


def test_dw3x3_variant_follows_the_shape(dev):
    rng = np.random.default_rng(9)
    ck.reset_counts()
    for C, variant in ((20, "strip"), (6, "general")):
        op = ck.pack_dw3x3(rng.integers(-128, 128, (9, C)).astype(np.int8),
                           np.full(C, 1e-3, np.float32), np.zeros(C, np.float32),
                           zp_in=-3, s_out=0.02, zp_out=1, device=dev)
        xd = _t(rng.integers(-128, 128, (1, 5, 6, C)).astype(np.int8), dev)
        _equal(ck.dw3x3_int8_requant_packed(xd, op), ck.dw3x3_int8_requant_plain(xd, op))
        assert ck.VARIANTS["dw3x3_int8_requant"][variant] == 1


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


def _stride2_dw_sites(build, size):
    """``(node, H, W, C)`` of every 3x3 depthwise conv of stride 2 and
    padding 1 of a model's graph at ``size``, H and W its input's."""
    graph, hw, sites = build(), {}, []
    for node in graph:
        if node.op == "input":
            hw[node.name] = (size, size)
            continue
        h, w = hw[node.inputs[0]]
        a = node.attrs
        if node.op == "conv":
            (kh, kw), (sh, sw) = a["kernel"], a["stride"]
            (ph, pw), (dh, dw) = a["padding"], a["dilation"]
            hw[node.name] = ((h + 2 * ph - dh * (kh - 1) - 1) // sh + 1,
                             (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1)
            if ((kh, kw, sh, sw, ph, pw, dh, dw) == (3, 3, 2, 2, 1, 1, 1, 1)
                    and a["groups"] == a["in_ch"] == a["out_ch"]):
                sites.append((node.name, h, w, a["in_ch"]))
        else:  # the sites lie before any op that changes the map otherwise
            hw[node.name] = (h, w)
    return sites


_S2_MODELS = {"mobilenet_v2": ("mobilenet_v2", 224, 4),
              "ssd_lite": ("mobilenet_v2_ssd_lite", 300, 8)}


@pytest.mark.parametrize("batch", [1, 8, 128])
@pytest.mark.parametrize("model", sorted(_S2_MODELS))
def test_dw3x3_stride2_variants_equal_plain_at_every_site(dev, model, batch):
    """K2's stride-2 strip variant, and its general variant on an input 4
    bytes off its 16-byte boundary, bit-equal to the plain version at
    every stride-2 site of the benchmark models (odd inputs 75, 19, 5, 3;
    maps narrower than a strip), zero points at both ends of the grid."""
    import dfq_tpu_torch.models as models

    fn, size, n_sites = _S2_MODELS[model]
    sites = _stride2_dw_sites(getattr(models, fn), size)
    assert len(sites) == n_sites
    for i, (name, H, W, C) in enumerate(sites):
        rng = np.random.default_rng(i + batch)
        op = ck.pack_dw3x3(rng.integers(-128, 128, (9, C)).astype(np.int8),
                           rng.uniform(1e-4, 2e-3, C).astype(np.float32),
                           rng.normal(0, 1, C).astype(np.float32),
                           zp_in=(-128, 0, 127)[i % 3], s_out=0.0193, zp_out=-17, stride=2,
                           device=dev)
        x = _t(rng.integers(-128, 128, (batch, H, W, C)).astype(np.int8), dev)
        buf = torch.empty(x.numel() + 16, dtype=torch.int8, device=dev)
        x_off = buf[4:4 + x.numel()].view(x.shape)
        x_off.copy_(x)
        want = ck.dw3x3_int8_requant_plain(x, op)
        for xv, variant in ((x, "strip_s2"), (x_off, "general_s2")):
            ck.reset_counts()
            got = ck.dw3x3_int8_requant_packed(xv, op)
            assert ck.VARIANTS["dw3x3_int8_requant"][variant] == 1, (name, variant)
            _equal(got, want)


@pytest.mark.parametrize("model", sorted(_S2_MODELS))
def test_stride2_dw_on_k2_equals_the_glue_route_forward(dev, model, monkeypatch):
    """The b128 forward with the stride-2 depthwise convs on K2 bit-equal
    to the same net built with the stride-2 test off (the glue route:
    ``int8_conv`` and the conv step's epilogue), which launches K2 that
    many times less."""
    import dfq_tpu_torch.models as models
    from dfq_tpu_torch.engine import Int8FusedNet, int8_fused, lower_int8
    from dfq_tpu_torch.models import init_params
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    fn, size, n_sites = _S2_MODELS[model]
    g = getattr(models, fn)()
    flags = dict(delete_single=True, is_detection=True) if model == "ssd_lite" else {}
    prep = prepare(g, init_params(g, seed=0, bn_stats="random"),
                   QuantConfig(quantize=True, relu=True, equalize=True, bits_bias=16, **flags))
    model_i8 = lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model_i8.layers}
    net = Int8FusedNet(model_i8, device=dev, params_f32=residual)
    monkeypatch.setattr(int8_fused, "_is_dw2", lambda node: False)
    glue = Int8FusedNet(model_i8, device=dev, params_f32=residual)
    monkeypatch.undo()
    rng = np.random.default_rng(size)
    x = _t(rng.uniform(-1, 1, (128, size, size, 3)).astype(np.float32), dev)
    runs = []
    for n in (net, glue):
        ck.reset_counts()
        with torch.no_grad():
            out = n(x)
        torch.cuda.synchronize()
        runs.append((out if isinstance(out, tuple) else (out,), dict(ck.LAUNCHES),
                     dict(ck.VARIANTS["dw3x3_int8_requant"])))
    (got, launches, k2), (want, glue_launches, _) = runs
    assert launches["dw3x3_int8_requant"] == glue_launches["dw3x3_int8_requant"] + n_sites
    assert k2["strip_s2"] == n_sites
    for a, b in zip(got, want):
        _equal(a, b)


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


# the 7 shape classes of K3 on the MobileNetV2 main path: (C, E, C2)
_K3_CLASSES = [(24, 144, 24), (32, 192, 32), (64, 384, 64), (64, 384, 96), (96, 576, 96),
               (160, 960, 160), (160, 960, 320)]


@pytest.mark.parametrize("variant", ["mma", "general"])
@pytest.mark.parametrize("N", [1, 3])
@pytest.mark.parametrize("hw", [7, 14, 28, 10, 13])
@pytest.mark.parametrize("cls", _K3_CLASSES, ids=lambda c: "x".join(map(str, c)))
def test_fused_block_variants_at_main_path_widths(dev, cls, hw, N, variant):
    C, E, C2 = cls
    rng = np.random.default_rng(C + E + C2 + hw + N)
    res = C == C2
    # the flags walk through their combinations over the cases
    req_c1, req_r, out_f32 = bool(hw % 2), bool(N % 3 == 0), bool((hw + C2 // 8) % 3 == 0)
    x_grid = (0.0412, -9)
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
        x_grid=x_grid, c1_grid=(0.0377, 4) if req_c1 else x_grid,
        e_grid=(0.0213, -128 if hw % 2 else -77), d_grid=(0.0531, -128 if N == 1 else 19),
        act1_hi=3.4e38 if hw != 14 else 6.0, act2_hi=6.0,
        res_grid=((0.0450, -2) if req_r else x_grid) if res else None,
        p_grid=(0.0301, 5) if res else None,
        out_grid=None if out_f32 else (0.0622, -1), device=dev)
    x = rng.integers(-128, 128, (N, hw, hw, C)).astype(np.int8)
    if variant == "mma":
        xd = _t(x, dev)
    else:  # 4 bytes off a 16-byte boundary: the caller must take the general variant
        buf = torch.empty(x.size + 4, dtype=torch.int8, device=dev)
        xd = buf[4:].view(x.shape)
        xd.copy_(_t(x, dev))
        assert xd.data_ptr() % 16 == 4
    ck.reset_counts()
    got = ck.fused_block_int8_packed(xd, op)
    assert ck.VARIANTS["fused_block_int8"][variant] == 1
    _equal(got, ck.fused_block_int8_plain(xd, op))


def test_fused_block_variant_follows_the_shape(dev):
    rng = np.random.default_rng(2)
    ck.reset_counts()
    for (C, E, C2), variant in (((24, 144, 32), "mma"), ((12, 72, 12), "general"),
                                ((24, 144, 20), "general")):
        w1 = rng.integers(-128, 128, (C, E)).astype(np.int8)
        w2 = rng.integers(-128, 128, (E, C2)).astype(np.int8)
        op = ck.pack_fused_block(
            w1, np.full(E, 3e-4, np.float32), np.zeros(E, np.float32),
            w1.astype(np.int32).sum(0), rng.integers(-128, 128, (9, E)).astype(np.int8),
            np.full(E, 2e-3, np.float32), np.zeros(E, np.float32), w2,
            np.full(C2, 5e-5, np.float32), np.zeros(C2, np.float32),
            w2.astype(np.int32).sum(0), x_grid=(0.04, -9), c1_grid=(0.04, -9),
            e_grid=(0.02, -128), d_grid=(0.05, -128), act1_hi=6.0, act2_hi=6.0,
            out_grid=(0.06, -1), device=dev)
        xd = _t(rng.integers(-128, 128, (2, 9, 11, C)).astype(np.int8), dev)
        _equal(ck.fused_block_int8_packed(xd, op), ck.fused_block_int8_plain(xd, op))
        assert ck.VARIANTS["fused_block_int8"][variant] >= 1
    assert ck.VARIANTS["fused_block_int8"] == {"mma": 1, "general": 2}


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


# -- the exact int8 products of the engines' non-kernel convs and linears --

def _node(cin, cout, k, stride=1, dilation=1, groups=1):
    from dfq_tpu_torch.graph.ir import Node

    return Node("c", "conv", ("x",), {
        "in_ch": cin, "out_ch": cout, "kernel": (k, k), "stride": (stride, stride),
        "padding": (k // 2 * dilation,) * 2, "dilation": (dilation, dilation),
        "groups": groups})


@pytest.mark.parametrize("cin,cout,k,stride,dilation,groups,n,hw,route", [
    (3, 64, 7, 2, 1, 1, 3, 20, "f32"),        # the ResNet stem: Cin 3, K = 147
    (3, 32, 3, 2, 1, 1, 1, 9, "f32"),         # the MobileNetV2 stem
    (96, 96, 3, 2, 1, 96, 2, 9, "f32"),       # stride-2 depthwise
    (64, 64, 3, 1, 1, 1, 1, 4, "int_mm"),     # M = 16: padded above 16
    (512, 60, 3, 1, 1, 1, 3, 3, "int_mm"),    # K = 4608, N not a multiple of 8
    (128, 256, 1, 2, 1, 1, 8, 7, "int_mm"),   # a downsample conv
    (130, 24, 3, 1, 2, 1, 2, 6, "int_mm"),    # K > 1024, Cin not a multiple of 8
    (256, 64, 3, 1, 1, 2, 1, 4, "int_mm"),    # grouped, K = 1152 a group: a group at a time
])
def test_int8_conv_routes_exact_on_cuda(dev, cin, cout, k, stride, dilation, groups, n, hw,
                                        route):
    import torch.nn.functional as F

    from dfq_tpu_torch.engine.int8 import int8_conv, pack_int8_product

    rng = np.random.default_rng(cin * k + n)
    node = _node(cin, cout, k, stride, dilation, groups)
    qw = rng.integers(-128, 128, (cout, cin // groups, k, k)).astype(np.int8)
    prod = pack_int8_product(qw, node, dev)
    assert prod.route == route
    x = _t(rng.integers(-128, 128, (n, hw, hw, cin)).astype(np.int8), dev)
    zp = -21
    got = int8_conv(x, node, prod, zp)
    a = node.attrs
    xp = F.pad(x.permute(0, 3, 1, 2).double(), (a["padding"][1],) * 2 + (a["padding"][0],) * 2,
               value=zp)
    want = F.conv2d(xp, torch.from_numpy(qw).to(dev).double(), stride=a["stride"],
                    dilation=a["dilation"], groups=groups).permute(0, 2, 3, 1)
    _equal(got, want.to(torch.int32))


@pytest.mark.parametrize("m,k,n", [(1, 1280, 1000), (3, 512, 1000), (8, 512, 1000),
                                   (4, 8, 10), (17, 147, 13)])
def test_int8_linear_exact_on_cuda(dev, m, k, n):
    from dfq_tpu_torch.engine.int8 import int8_linear, pack_int8_product
    from dfq_tpu_torch.graph.ir import Node

    rng = np.random.default_rng(m + k)
    qw = rng.integers(-128, 128, (n, k)).astype(np.int8)
    prod = pack_int8_product(qw, Node("fc", "linear", ("x",), {}), dev)
    assert prod.route == "int_mm"
    x = _t(rng.integers(-128, 128, (m, k)).astype(np.int8), dev)
    want = (x.double() @ torch.from_numpy(qw).to(dev).double().t()).to(torch.int32)
    _equal(int8_linear(x, prod), want)


def test_int8_maxpool_pad_on_cuda_equal_cpu(dev):
    """The fused engine's int8 max pooling and padding on the card equal
    the CPU's (through a lowered conv on each side)."""
    from dfq_tpu_torch.engine import Int8FusedNet, Int8Layer, Int8Model
    from dfq_tpu_torch.graph.ir import GraphBuilder

    b = GraphBuilder()
    x = b.input("data")
    x = b.conv("c1", x, 3, 16, (3, 3), padding=(1, 1))
    x = b.relu("r1", x)
    mp = b.maxpool("mp", x, window=(3, 3), stride=(2, 2), padding=(1, 1))
    x = b.pad("pd", mp, pads=(1, 2, 0, 1))
    x = b.conv("c2", x, 16, 8, (3, 3))
    y = b.conv("c3", mp, 16, 8, (1, 1))
    graph = b.build([x, y])
    rng = np.random.default_rng(0)

    def layer(o, i, k, scale, zp):
        qw = rng.integers(-128, 128, (o, i, k, k)).astype(np.int8)
        return Int8Layer(qw, np.full(o, 2e-3, np.float32), rng.normal(0, 0.1, o).astype(
            np.float32), qw.astype(np.int32).reshape(o, -1).sum(1), scale, zp)

    model = Int8Model(graph, {"c1": layer(16, 3, 3, 0.0185, -14), "c2": layer(8, 16, 3, 0.05, -128),
                              "c3": layer(8, 16, 1, 0.05, -128)},
                      {"c1:in0": (-2.1179, 2.64), "c2:in0": (0.0, 12.75), "c3:in0": (0.0, 12.75)})
    xs = torch.from_numpy(rng.normal(0, 1, (3, 17, 15, 3)).astype(np.float32))
    with torch.no_grad():
        want = Int8FusedNet(model, device="cpu")(xs)
        net = Int8FusedNet(model, device=dev)
        assert net._grids["mp"] is not None and net._grids["pd"] is not None
        got = net(xs.to(dev))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


# -- the detection and segmentation paths' shapes (SSD-Lite 300x300,
# DeepLab-v3+ MobileNetV2 513x513) --

@pytest.mark.parametrize("M,K,N", [
    (8 * 361, 576, 126), (8 * 100, 1280, 126), (8 * 25, 512, 126), (3 * 9, 256, 126),
    (3 * 4, 256, 126), (3, 64, 126),  # SSD-Lite's class heads, N = 6 * 21
    (4 * 16641, 256, 21), (3 * 16641, 256, 21),  # DeepLab's classifier
])
def test_matmul_dp4a_variant_at_the_head_sites(dev, M, K, N):
    """Sites that only the dp4a variant took before N was padded: now the
    resident variant on N padded to a multiple of 8, rows stored at any
    byte width."""
    _mm_case(dev, M, K, N, "none", N == 126, "mma")


@pytest.mark.parametrize("out_f32", [False, True])
@pytest.mark.parametrize("M", [1, 8, 17, 300])
@pytest.mark.parametrize("K", [2048, 4096, 9216])
@pytest.mark.parametrize("N", [1, 21, 126])
def test_matmul_stream_variant_equals_plain(dev, N, K, M, out_f32):
    """The streamed variant at ragged N, K past a whole-K tile and batch
    rows: bit-equal to the plain version, and a launch split over K
    gives the same bits twice (its K parts add by int32 atomics)."""
    rng = np.random.default_rng(M + K + N)
    x = rng.integers(-128, 128, (M, K)).astype(np.int8)
    w = rng.integers(-128, 128, (N, K)).astype(np.int8)
    op = ck.pack_matmul(w, rng.uniform(1e-6, 2e-5, N).astype(np.float32),
                        rng.normal(0, 1, N).astype(np.float32),
                        w.astype(np.int32).sum(1), zp_in=-5, s_out=0.0371, zp_out=-20,
                        act="relu", out_f32=out_f32, device=dev)
    xd = _t(x, dev)
    plan = ck.matmul_plan(M, K, N, out_f32)
    assert plan.variant == "stream"
    ck.reset_counts()
    got = ck.matmul_int8_requant_packed(xd, op)
    again = ck.matmul_int8_requant_packed(xd, op)
    assert ck.VARIANTS["matmul_int8_requant"] == {"mma": 0, "stream": 2, "dp4a": 0}
    _equal(got, ck.matmul_int8_requant_plain(xd, op))
    if plan.grid[2] > 1:
        _equal(again, got)


@pytest.mark.parametrize("shape", [(9, 8, 12), (777, 96, 126), (70000, 24, 21), (5, 1280, 3)])
def test_matmul_ragged_n_on_the_resident_variant(dev, shape):
    """N not a multiple of 8 on the resident variant: one run a warp where
    a block holds all N columns, a run a row where the columns are split
    over blocks; odd row widths in int8 and f32."""
    M, K, N = shape
    for out_f32 in (False, True):
        assert ck.matmul_plan(M, K, N, out_f32).variant == "mma"
        _mm_case(dev, M, K, N, "relu6", out_f32, "mma")


@pytest.mark.parametrize("shape", [(3, 150, 150, 32), (3, 19, 19, 576), (3, 10, 10, 1280),
                                   (8, 5, 5, 512), (8, 3, 3, 256), (8, 2, 2, 256)])
def test_dw3x3_strip_variant_at_ssd_sites(dev, shape):
    test_dw3x3_strip_variant_equals_plain(dev, shape, -128, False)


# SSD-Lite's K3 shape classes (H = W, C, E, C2): slabs that do not divide
# the map, rows padded from 75/38/19/10 to a multiple of 8
_SSD_K3 = [(75, 24, 144, 24), (38, 32, 192, 32), (19, 64, 384, 96), (10, 160, 960, 320)]


@pytest.mark.parametrize("N", [3, 8])
@pytest.mark.parametrize("site", _SSD_K3, ids=lambda s: "x".join(map(str, s)))
def test_fused_block_mma_variant_at_ssd_sites(dev, site, N):
    H, C, E, C2 = site
    rng = np.random.default_rng(H + N)
    w1 = rng.integers(-128, 128, (C, E)).astype(np.int8)
    w2 = rng.integers(-128, 128, (E, C2)).astype(np.int8)
    res = C == C2
    op = ck.pack_fused_block(
        w1, rng.uniform(1e-4, 5e-4, E).astype(np.float32),
        rng.normal(0, 0.5, E).astype(np.float32), w1.astype(np.int32).sum(0),
        rng.integers(-128, 128, (9, E)).astype(np.int8),
        rng.uniform(1e-3, 4e-3, E).astype(np.float32),
        rng.normal(0, 0.5, E).astype(np.float32),
        w2, rng.uniform(1e-5, 1e-4, C2).astype(np.float32),
        rng.normal(0, 0.5, C2).astype(np.float32), w2.astype(np.int32).sum(0),
        x_grid=(0.0412, -9), c1_grid=(0.0412, -9), e_grid=(0.0213, -128),
        d_grid=(0.0531, -128), act1_hi=3.4e38, act2_hi=3.4e38,
        res_grid=(0.0450, -2) if res else None, p_grid=(0.0301, 5) if res else None,
        out_grid=(0.0622, -1), device=dev)
    xd = _t(rng.integers(-128, 128, (N, H, H, C)).astype(np.int8), dev)
    ck.reset_counts()
    got = ck.fused_block_int8_packed(xd, op)
    assert ck.VARIANTS["fused_block_int8"] == {"mma": 1, "general": 0}
    _equal(got, ck.fused_block_int8_plain(xd, op))


@pytest.mark.parametrize("cin,cout,dilation,n,hw", [
    (320, 256, 6, 2, 33), (320, 256, 12, 1, 33), (320, 256, 18, 1, 33),  # ASPP, K = 2880
    (304, 256, 1, 1, 65), (256, 256, 1, 1, 65),  # the decoder's 3x3 convs
])
def test_int8_conv_dilated_and_decoder_convs_exact_on_cuda(dev, cin, cout, dilation, n, hw):
    test_int8_conv_routes_exact_on_cuda(dev, cin, cout, 3, 1, dilation, 1, n, hw, "int_mm")


@pytest.mark.parametrize("c,dilation,stride", [(96, 1, 2), (384, 2, 1), (960, 4, 1)])
def test_int8_conv_unpadded_depthwise_exact_on_cuda(dev, c, dilation, stride):
    """DeepLab's depthwise convs: the block's input padded explicitly, the
    conv unpadded, dilated in the later stages."""
    import torch.nn.functional as F

    from dfq_tpu_torch.engine.int8 import int8_conv, pack_int8_product

    rng = np.random.default_rng(c + dilation)
    node = _node(c, c, 3, stride, dilation, c)
    node.attrs["padding"] = (0, 0)
    qw = rng.integers(-128, 128, (c, 1, 3, 3)).astype(np.int8)
    prod = pack_int8_product(qw, node, dev)
    x = _t(rng.integers(-128, 128, (2, 21, 21, c)).astype(np.int8), dev)
    want = F.conv2d(x.permute(0, 3, 1, 2).double(), torch.from_numpy(qw).to(dev).double(),
                    stride=stride, dilation=dilation, groups=c).permute(0, 2, 3, 1)
    _equal(int8_conv(x, node, prod, -7), want.to(torch.int32))


# the fused engine's conv rewrites at SSD-Lite's and DeepLab's shapes:
# (cin, cout, k, stride, dilation, groups, batch, map)
_REWRITE_SITES = {
    "ssd_stem": (3, 32, 3, 2, 1, 1, 2, 300),
    "ssd_dw32": (32, 32, 3, 1, 1, 32, 2, 150),
    "ssd_dw96_s2": (96, 96, 3, 2, 1, 96, 2, 150),
    "ssd_extra_s2": (256, 512, 3, 2, 1, 1, 2, 10),
    "deeplab_stem": (3, 32, 3, 2, 1, 1, 2, 513),
    "deeplab_aspp_d6": (320, 256, 3, 1, 6, 1, 2, 33),
    "deeplab_aspp_d12": (320, 256, 3, 1, 12, 1, 2, 33),
    "deeplab_aspp_d18": (320, 256, 3, 1, 18, 1, 2, 33),
    "deeplab_decoder": (304, 256, 3, 1, 1, 1, 2, 129),
}


@pytest.mark.parametrize("site", sorted(_REWRITE_SITES))
def test_conv_rewrites_equal_int8_conv_on_cuda(dev, site):
    """shift9, im2col and the batch-to-space fold, and the policies'
    weight rewrites (channel padding, dense-diagonal depthwise, the s2d
    stem), bit-equal to :func:`int8_conv`'s default route on the card."""
    import torch.nn.functional as F

    import dfq_tpu_torch.engine.int8 as ti8
    import dfq_tpu_torch.engine.int8_fused as tf

    cin, cout, k, stride, dilation, groups, n, hw = _REWRITE_SITES[site]
    rng = np.random.default_rng(cin + hw)
    node = _node(cin, cout, k, stride, dilation, groups)
    qw = rng.integers(-128, 128, (cout, cin // groups, k, k)).astype(np.int8)
    x = _t(rng.integers(-128, 128, (n, hw, hw, cin)).astype(np.int8), dev)
    zp = -19
    want = ti8.int8_conv(x, node, ti8.pack_int8_product(qw, node, dev), zp)
    forms = {"b2s": ti8.int8_conv_b2s} if ti8.b2s_applicable(node, hw) else {}
    if groups == 1:
        forms.update(shift9=ti8.int8_conv_shift9, im2col=ti8.int8_conv_im2col)
    for form, fn in forms.items():
        _equal(fn(x, node, ti8.pack_int8_product(qw, node, dev, form), zp), want)
    cpad = tf._chpad_target(cin, (k, k), groups) or (384 if cin == 304 else 0)
    if cpad:
        node_p = node.replace(attrs={**node.attrs, "in_ch": cpad})
        qw_p = np.concatenate([qw, np.zeros((cout, cpad - cin, k, k), np.int8)], axis=1)
        x_p = F.pad(x, (0, cpad - cin), value=zp)
        for form in ("conv", "shift9", "im2col"):
            fn = {"conv": ti8.int8_conv, "shift9": ti8.int8_conv_shift9,
                  "im2col": ti8.int8_conv_im2col}[form]
            _equal(fn(x_p, node_p, ti8.pack_int8_product(qw_p, node_p, dev, form), zp), want)
    if groups > 1:
        node_d = node.replace(attrs={**node.attrs, "groups": 1})
        prod_d = ti8.pack_int8_product(tf._dense_diag_weights(qw), node_d, dev)
        _equal(ti8.int8_conv(x, node_d, prod_d, zp), want)
    if cin == 3 and hw % 2 == 0:
        attrs = {**node.attrs, "kernel": (2, 2), "stride": (1, 1), "padding": (0, 0),
                 "in_ch": 12}
        node_s = node.replace(attrs=attrs)
        prod_s = ti8.pack_int8_product(tf._s2d_weights(qw), node_s, dev)
        _equal(ti8.int8_conv(tf._space_to_depth2(x, zp, pad=1), node_s, prod_s, zp), want)


# -- calibration (ZeroQ) on the card against the CPU --------------------------

def _small_cnn():
    """``tests/test_calibration.py``'s ``_small_cnn``, in the port's builder."""
    from dfq_tpu_torch.graph import GraphBuilder

    b = GraphBuilder()
    x = b.input("data")
    x = b.conv("c1", x, 3, 8, (3, 3), stride=(2, 2), padding=(1, 1))
    x = b.bn("n1", x, 8)
    x = b.relu("r1", x)
    x = b.conv("c2", x, 8, 12, (3, 3), stride=(2, 2), padding=(1, 1))
    x = b.bn("n2", x, 12)
    x = b.relu("r2", x)
    x = b.global_mean("gm", x)
    x = b.linear("fc", x, 12, 4)
    return b.build([x])


def test_distill_loss_and_grad_card_vs_cpu(dev):
    """The f32 distillation loss and its gradient on the card equal the
    CPU's to the CPU test's limits (tests/test_torch_calib.py): TF32 or an
    inexact conv algorithm would break them."""
    import dataclasses

    from dfq_tpu_torch.calib.distill import (
        DistillConfig,
        init_random_batch,
        loss_and_grad,
        make_loss_fn,
    )
    from dfq_tpu_torch.models import init_params

    g = _small_cnn()
    p = init_params(g, seed=0, bn_stats="random")
    cfg = DistillConfig(batch_size=16, image_size=(16, 16), compute_dtype="f32")
    x0 = init_random_batch(np.random.default_rng(0), cfg)
    out = {}
    for d in (dev, torch.device("cpu")):
        loss_fn, _ = make_loss_fn(g, p, dataclasses.replace(cfg, device=str(d)))
        loss, grad = loss_and_grad(loss_fn, torch.from_numpy(x0).to(d))
        out[d.type] = (float(loss), grad.cpu().numpy())
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-6 * abs(lh), (lc, lh)
    assert np.abs(gc - gh).max() <= 1e-5 * np.abs(gh).max(), np.abs(gc - gh).max() / np.abs(
        gh).max()


def test_calibrate_ranges_card_vs_cpu(dev):
    from dfq_tpu_torch.calib import calibrate_ranges
    from dfq_tpu_torch.models import init_params
    from dfq_tpu_torch.passes import fold_batchnorm, quantize_layer_weights

    gf, pf = fold_batchnorm(_small_cnn(), init_params(_small_cnn(), seed=0, bn_stats="random"))
    pq = quantize_layer_weights(gf, pf, bits_weight=4, bits_bias=32)
    rng = np.random.default_rng(3)
    batches = [rng.normal(0, 1, (8, 16, 16, 3)).astype(np.float32) for _ in range(3)]
    card = calibrate_ranges(gf, pq, batches, device=dev)
    cpu = calibrate_ranges(gf, pq, batches, device="cpu")
    assert card.keys() == cpu.keys()
    for site, (lo, hi) in cpu.items():
        step = (hi - lo) / 255.0
        assert abs(card[site][0] - lo) <= step and abs(card[site][1] - hi) <= step, site


def test_aot_payload_round_trip_on_the_card(dev, tmp_path):
    """``run_cls --aot-batch`` writes the kernel libraries and meta.json;
    ``load_aot_forward`` gives the exporting forward's logits bit for bit;
    another card's name in meta.json is refused."""
    import json

    from dfq_tpu_torch.cli import run_cls
    from dfq_tpu_torch.io import aot
    from dfq_tpu_torch.ops import _build

    art = tmp_path / "art"
    out = run_cls.main(["--quantize", "--relu", "--equalize", "--engine", "fused",
                        "--save-artifact", str(art), "--aot-batch", "4"])
    meta = json.loads((art / "aot" / "meta.json").read_text())
    assert meta["batch"] == 4 and meta["device_name"] == torch.cuda.get_device_name(dev)
    assert meta["sources_sha256"] == _build.sources_digest()
    assert sorted(meta["libraries"]) == sorted(_build.SOURCES)
    fwd = aot.load_aot_forward(str(art))
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (8, 224, 224, 3)).astype(
        np.float32)).to(dev)
    with torch.no_grad():
        assert np.array_equal(fwd(x).cpu().numpy(), out["logits"])
    (art / "aot" / "meta.json").write_text(json.dumps(dict(meta, capability="8.0")))
    with pytest.raises(ValueError, match="re-export on matching hardware"):
        aot.load_aot_forward(str(art))


def test_native_runtime_against_the_card(dev, tmp_path):
    """``convert --validate``: the native runtime on the host against
    ``Int8Net`` on the card, every top-1 equal, under the contract of
    tests/test_native_runtime.py."""
    from dfq_tpu_torch.cli import convert

    out = convert.main(["--relu", "--equalize", "--validate", "--out", str(tmp_path / "m")])
    d = np.abs(out["native"] - out["engine"])
    assert out["top1_agreement"] == 1.0
    assert d.mean() < 2e-3 and d.max() < 5e-2 and float(np.mean(d < 5e-3)) > 0.9


@pytest.mark.parametrize("N", [1, 8, 128])
def test_fused_block_mma_variant_at_the_mobilenet_v1_c2_1024_block(dev, N):
    """MobileNetV1's last block (10x10, C 512, E 1024, C2 1024) shares its
    output columns over blocks at every batch (the plan repair of
    ``fused_block_plan``) and equals the plain version."""
    rng = np.random.default_rng(N)
    H, C, E, C2 = 10, 512, 1024, 1024
    w1 = rng.integers(-128, 128, (C, E)).astype(np.int8)
    w2 = rng.integers(-128, 128, (E, C2)).astype(np.int8)
    op = ck.pack_fused_block(
        w1, rng.uniform(1e-5, 5e-5, E).astype(np.float32),
        rng.normal(0, 0.5, E).astype(np.float32), w1.astype(np.int32).sum(0),
        rng.integers(-128, 128, (9, E)).astype(np.int8),
        rng.uniform(1e-3, 4e-3, E).astype(np.float32),
        rng.normal(0, 0.5, E).astype(np.float32),
        w2, rng.uniform(1e-6, 1e-5, C2).astype(np.float32),
        rng.normal(0, 0.5, C2).astype(np.float32), w2.astype(np.int32).sum(0),
        x_grid=(0.0412, -9), c1_grid=(0.0412, -9), e_grid=(0.0213, -128),
        d_grid=(0.0531, -128), act1_hi=3.4e38, act2_hi=3.4e38, out_grid=(0.0622, -1),
        device=dev)
    assert ck.fused_block_plan(N, H, H, C, E, C2).variant == "mma"
    x = torch.from_numpy(rng.integers(-128, 128, (N, H, H, C)).astype(np.int8)).to(dev)
    ck.reset_counts()
    got = ck.fused_block_int8_packed(x, op)
    assert ck.VARIANTS["fused_block_int8"] == {"mma": 1, "general": 0}
    _equal(got, ck.fused_block_int8_plain(x, op))


# -- parallel/ on the card ------------------------------------------------------

@pytest.mark.parametrize("n_shards", [3, 4])
def test_sharded_fused_forward_on_one_card(dev, n_shards):
    """MobileNetV2 96x96 b12 split over ``n_shards`` shards on the card:
    logits bit-equal to the single forward (on the first call, run step
    by step, captured and replayed, and on a call that only replays), and
    11 / 5 / 12 kernel calls a shard in a trace of the replaying call."""
    from dfq_tpu_torch.engine import Int8FusedNet, lower_int8
    from dfq_tpu_torch.models import init_params, mobilenet_v2
    from dfq_tpu_torch.parallel import data_mesh, make_sharded_eval, make_sharded_forward
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    g = mobilenet_v2()
    prep = prepare(g, init_params(g, seed=0, bn_stats="random"),
                   QuantConfig(quantize=True, relu=True, equalize=True, bits_bias=16))
    model = lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model.layers}
    rng = np.random.default_rng(n_shards)
    x = _t(rng.normal(0, 1, (12, 96, 96, 3)).astype(np.float32), dev)
    with torch.no_grad():
        single = Int8FusedNet(model, device=dev, params_f32=residual)(x)
    labels = single.argmax(-1).cpu().numpy()
    labels[::3] = (labels[::3] + 1) % 1000
    mesh = data_mesh(devices=[dev] * n_shards)
    fwd = make_sharded_forward(None, residual, mesh, int8_model=model, engine="fused")
    first = fwd(x)
    fwd(x)  # by now the one replica has replayed its key's graph
    out, calls, _ = _traced_kernels(lambda: fwd(x))
    assert {k: calls[k] for k in ck.LAUNCHES} == {
        "matmul_int8_requant": 11 * n_shards, "dw3x3_int8_requant": 5 * n_shards,
        "fused_block_int8": 12 * n_shards}
    _equal(first.gather(), single)
    assert [s.shape[0] for s in out.shards] == [12 // n_shards] * n_shards
    _equal(out.gather(), single)
    run = make_sharded_eval(None, residual, mesh, int8_model=model, engine="fused")
    assert run(x, labels) == (8, 12)


def test_kernels_launch_on_the_inputs_device_and_stream(dev):
    """Each wrapper launches on the current stream of its input's device:
    on a side stream, inside a CUDA-graph capture (a launch on another
    stream would break the capture), and on every visible card from
    device 0's context."""
    rng = np.random.default_rng(0)
    for i in range(torch.cuda.device_count()):
        d = torch.device("cuda", i)
        w = rng.integers(-128, 128, (96, 64)).astype(np.int8)
        op = ck.pack_matmul(w, np.full(96, 1e-3, np.float32), np.zeros(96, np.float32),
                            w.astype(np.int32).sum(1), zp_in=-3, s_out=0.05, zp_out=1, device=d)
        x = _t(rng.integers(-128, 128, (300, 64)).astype(np.int8), d)
        want = ck.matmul_int8_requant_plain(x, op)
        with torch.cuda.device(0):
            _equal(ck.matmul_int8_requant_packed(x, op), want)
        side = torch.cuda.Stream(d)
        with torch.cuda.device(d), torch.cuda.stream(side):
            assert ck._stream(d) == side.cuda_stream
            got = ck.matmul_int8_requant_packed(x, op)
        side.synchronize()
        _equal(got, want)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(d):
            ck.matmul_int8_requant_packed(x, op)  # warm-up outside the capture
            torch.cuda.synchronize(d)
            with torch.cuda.graph(graph):
                out = ck.matmul_int8_requant_packed(x, op)
            graph.replay()
            torch.cuda.synchronize(d)
        _equal(out, want)


# -- the glue convs' epilogue (ops/conv_epilogue.py) -----------------------------

def _epi_acc(dev, layout: str, rng):
    """An accumulator of [3, 17, 19, C] in one of the layouts the product
    routes leave, and the kernel variant that layout takes."""
    b, h, w = 3, 17, 19
    if layout.startswith("int32"):
        c, pitch, off = {"int32_pitch": (48, 56, 0), "int32_ragged": (21, 24, 0),
                         "int32_unaligned": (48, 48, 1)}[layout]
        v = rng.integers(-2**31, 2**31, b * h * w * pitch + off, dtype=np.int64)
        v[::7] = rng.integers(-3000, 3000, v[::7].shape)  # values that quantize inside the grid
        rows = _t(v.astype(np.int32), dev)[off:].view(b * h * w, pitch)[:, :c]
        variant = "rows_vec" if layout == "int32_pitch" else "rows"
        return rows.reshape(b, h, w, c), c, variant
    c = 42 if layout == "f32_cl_ragged" else 40
    v = rng.integers(-2**24, 2**24 + 1, (b, c, h, w)).astype(np.float32)
    v[..., ::3] = rng.integers(-3000, 3000, v[..., ::3].shape)
    acc = _t(v, dev)
    if layout.startswith("f32_cl"):
        return (acc.to(memory_format=torch.channels_last), c,
                "rows" if layout == "f32_cl_ragged" else "rows_vec")
    if layout == "f32_nchw_strided":  # every other channel plane of an NCHW tensor
        return _t(np.repeat(v, 2, axis=1), dev)[:, ::2], c, "rows"
    return acc, c, "rows"


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("out_i8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("layout", ["int32_pitch", "int32_ragged", "int32_unaligned",
                                    "f32_nchw", "f32_nchw_strided", "f32_cl",
                                    "f32_cl_ragged"])
def test_conv_epilogue_kernel_equals_plain(dev, layout, out_i8, bias):
    """Each variant of the epilogue kernel on the layouts it reads, with
    and without a bias, onto int8 codes and f32, bit-equal to the plain
    version (from the int32 and f32-exact extremes to values inside the
    grid)."""
    from dfq_tpu_torch.ops import conv_epilogue as cep

    rng = np.random.default_rng(len(layout) + 2 * out_i8 + bias)
    acc, c, variant = _epi_acc(dev, layout, rng)
    op = cep.pack_conv_epilogue(
        rng.integers(-20000, 20000, c).astype(np.int32),
        rng.uniform(1e-5, 3e-3, c).astype(np.float32),
        rng.normal(0, 2, c).astype(np.float32) if bias else None, zp=-9,
        grid=(0.0417, -5) if out_i8 else None, device=dev)
    v = cep._nhwc_view(acc, c)
    B, H, W, _ = v.shape
    plan = cep.conv_epilogue_plan(B, H, W, c, v.stride(), ck._aligned16(v), ck._sm_count(dev))
    assert plan.variant == variant
    cep.reset_counts()
    got = cep.conv_epilogue_packed(acc, op)
    assert (cep.EPILOGUE_LAUNCHES, cep.EPILOGUE_PLAIN_CALLS) == (1, 0)
    _equal(got, cep.conv_epilogue_plain(acc, op))


def test_conv_epilogue_launches_on_the_current_stream_and_in_a_graph(dev):
    from dfq_tpu_torch.ops import conv_epilogue as cep

    rng = np.random.default_rng(11)
    acc, c, _ = _epi_acc(dev, "int32_pitch", rng)
    op = cep.pack_conv_epilogue(rng.integers(-20000, 20000, c).astype(np.int32),
                                np.full(c, 1e-3, np.float32), np.zeros(c, np.float32), zp=3,
                                grid=(0.05, 1), device=dev)
    want = cep.conv_epilogue_plain(acc, op)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        got = cep.conv_epilogue_packed(acc, op)
    side.synchronize()
    _equal(got, want)
    graph = torch.cuda.CUDAGraph()
    cep.conv_epilogue_packed(acc, op)  # warm-up outside the capture
    torch.cuda.synchronize(dev)
    with torch.cuda.graph(graph):
        out = cep.conv_epilogue_packed(acc, op)
    graph.replay()
    _equal(out, want)


# the four benchmark cells' configurations: builder, QuantConfig flags, image
# size, and the fused engine's glue conv steps (ops/conv_epilogue.py launches)
_EPI_MODELS = {
    "mobilenet_v2_224": ("mobilenet_v2", {}, {}, 224, 1),
    "resnet18_224": ("resnet18", {}, {}, 224, 20),
    "ssdlite_mobilenet_v2_300": ("mobilenet_v2_ssd_lite", {"num_classes": 21},
                                 {"delete_single": True, "is_detection": True}, 300, 1),
    "deeplab_mobilenet_v2_513": ("deeplab_mobilenet_v2", {"n_class": 21, "output_stride": 16,
                                                          "input_size": 513}, {}, 513, 23),
}


@pytest.mark.parametrize("name", sorted(_EPI_MODELS))
def test_conv_epilogue_at_every_glue_conv_site(dev, name, monkeypatch):
    """Every glue conv of the four cells' configurations at b2: the kernel
    bit-equal to its plain version on the accumulator the site's route
    leaves, one launch a glue ``conv`` step, K1/K2/K3 launched at their
    sites as before, and the forward bit-equal to the plain-kernel net's."""
    from dfq_tpu_torch import models
    from dfq_tpu_torch.engine import Int8FusedNet, lower_int8
    from dfq_tpu_torch.ops import conv_epilogue as cep
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    builder, kwargs, flags, size, n_conv = _EPI_MODELS[name]
    g = getattr(models, builder)(**kwargs)
    prep = prepare(g, models.init_params(g, seed=0, bn_stats="random"),
                   QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                               correction=True, bits_bias=16, **flags))
    model = lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model.layers}
    kernel, sites = cep.conv_epilogue_packed, []

    def checking(acc, op):
        got = kernel(acc, op)
        _equal(got, cep.conv_epilogue_plain(acc, op))
        sites.append(acc.dtype)
        return got

    monkeypatch.setattr(cep, "conv_epilogue_packed", checking)
    net = Int8FusedNet(model, device=dev, params_f32=residual)
    assert sum(k == "conv" for _, k, _ in net.lowering(2).steps) == n_conv
    x = _t(np.random.default_rng(size).normal(0, 1, (2, size, size, 3)).astype(np.float32), dev)
    ck.reset_counts()
    cep.reset_counts()
    with torch.no_grad():
        out = net(x)
    torch.cuda.synchronize()
    assert cep.EPILOGUE_LAUNCHES == len(sites) == n_conv
    assert ck.LAUNCHES == {k: sum(1 for _, kk, _ in net.kernel_sites if kk == k)
                           for k in ck.LAUNCHES}
    cep.reset_counts()
    with torch.no_grad():
        want = Int8FusedNet(model, device=dev, params_f32=residual, plain_kernels=True)(x)
    assert cep.EPILOGUE_LAUNCHES == 0
    for o, w in zip(out if isinstance(out, tuple) else (out,),
                    want if isinstance(want, tuple) else (want,)):
        _equal(o, w)


# -- the forward as a CUDA graph (engine/int8_fused.py) ---------------------------

# the benchmark cells' batches of the four configurations
_CELL_BATCH = {"mobilenet_v2_224": 128, "resnet18_224": 128, "ssdlite_mobilenet_v2_300": 128,
               "deeplab_mobilenet_v2_513": 32}
_LOWERED: dict = {}


def _lowered(name):
    """``(model, residual f32 params, image size)`` of a cell's configuration
    (the flagship DFQ config), built once."""
    if name not in _LOWERED:
        from dfq_tpu_torch import models
        from dfq_tpu_torch.engine import lower_int8
        from dfq_tpu_torch.pipeline import QuantConfig, prepare

        builder, kwargs, flags, size, _ = _EPI_MODELS[name]
        g = getattr(models, builder)(**kwargs)
        prep = prepare(g, models.init_params(g, seed=0, bn_stats="random"),
                       QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                                   correction=True, bits_bias=16, **flags))
        model = lower_int8(prep)
        _LOWERED[name] = (model, {k: v for k, v in prep.params.items()
                                  if k not in model.layers}, size)
    return _LOWERED[name]


def _outs(out):
    return out if isinstance(out, tuple) else (out,)


def _step_by_step(net, x):
    """The forward run step by step, as a key's first forward runs it."""
    low = net.lowering(x.shape[0])
    return net._outputs(net._run_steps(low.steps, {net.input_name: x}, set()))


def _suffix_sites(net, batch):
    """``(kernel launches by kernel, epilogue launches)`` of the steps a
    replay runs after its graph (the lowering's suffix)."""
    low = net.lowering(batch)
    suffix = {n for n, _, _ in low.steps[low.cut:]}
    return ({k: sum(1 for n, kk, _ in low.kernel_sites if kk == k and n in suffix)
             for k in ck.LAUNCHES},
            sum(1 for n, _, _ in low.epilogue_sites if n in suffix))


def _counted(fn):
    """``fn()`` with the kernels' counters reset before it and the device
    synced after: ``(output, launches by kernel, epilogue launches)``."""
    from dfq_tpu_torch.ops import conv_epilogue as cep

    ck.reset_counts()
    cep.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, dict(ck.LAUNCHES), cep.EPILOGUE_LAUNCHES


def _traced_kernels(fn):
    """``fn()`` under ``torch.profiler``: ``(output, device calls of each
    hand-written kernel, and of the epilogue's as "conv_epilogue")``, as
    the benchmark's trace names them."""
    import re

    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import kernel_of

    epilogue = re.compile(r"\bconv_epilogue_rows_kernel\b")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    calls = dict.fromkeys([*ck.LAUNCHES, "conv_epilogue"], 0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = "conv_epilogue" if epilogue.search(e.name) else kernel_of(e.name)
            if k is not None:
                calls[k] += 1
    return out, calls, prof


@pytest.mark.parametrize("batch", ["b8", "b3", "cell"])
@pytest.mark.parametrize("name", sorted(_EPI_MODELS))
def test_graph_replay_equals_the_step_by_step_forward(dev, name, batch):
    """A key's first forward runs step by step, its second captures and
    replays, later ones replay: every replayed output bit-equal to the
    step-by-step forward on the same images, a result unchanged after a
    later call on other images; the first forward's kernel launches (by
    kernel, and the epilogue's) one a site of the lowering, and a
    replayed forward's only those of its suffix (the kernels' counters
    count wrapper calls, and a replay makes none)."""
    from dfq_tpu_torch.engine import Int8FusedNet, int8_fused

    model, residual, size = _lowered(name)
    n = {"b8": 8, "b3": 3, "cell": _CELL_BATCH[name]}[batch]
    net = Int8FusedNet(model, device=dev, params_f32=residual)
    rng = np.random.default_rng(n + size)
    xa, xb = (_t(rng.normal(0, 1, (n, size, size, 3)).astype(np.float32), dev)
              for _ in range(2))
    counts = dict(int8_fused.GRAPH_COUNTS)
    with torch.no_grad():
        want_a, want_b = _step_by_step(net, xa), _step_by_step(net, xb)
        first, *eager = _counted(lambda: net(xa))
        second = net(xb)
        assert len(net._graphs) == 1
        third, *replayed = _counted(lambda: net(xa))
        held = [o.clone() for o in _outs(third)]
        fourth = net(xb)
    assert {k: v - counts[k] for k, v in int8_fused.GRAPH_COUNTS.items()} == {
        "captures": 1, "replays": 3, "eager": 1}
    low = net.lowering(n)
    assert eager == [{k: sum(1 for _, kk, _ in low.kernel_sites if kk == k) for k in ck.LAUNCHES},
                     len(low.epilogue_sites)]
    assert tuple(replayed) == _suffix_sites(net, n)
    for got, want in ((first, want_a), (second, want_b), (third, want_a), (fourth, want_b)):
        for o, w in zip(_outs(got), _outs(want)):
            _equal(o, w)
    for o, h in zip(_outs(third), held):
        _equal(o, h)


def test_graph_capture_on_a_thread_new_to_the_net(dev):
    """A key's first forward on this thread, its second, the capture, on
    a new thread, as the serving pool's threads take turns: the capture
    makes that thread's library handles before it starts, and the replay
    is bit-equal to the step-by-step forward."""
    import threading

    from dfq_tpu_torch.engine import Int8FusedNet

    model, residual, size = _lowered("mobilenet_v2_224")
    net = Int8FusedNet(model, device=dev, params_f32=residual)
    x = _t(np.random.default_rng(8).normal(0, 1, (8, size, size, 3)).astype(np.float32), dev)
    got, errors = [], []

    def second():
        try:
            with torch.no_grad():
                got.append(net(x))
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    with torch.no_grad():
        want = _step_by_step(net, x)
        net(x)
    t = threading.Thread(target=second)
    t.start()
    t.join()
    assert not errors, errors
    assert len(net._graphs) == 1
    _equal(got[0], want)


def test_graph_replay_from_two_threads_on_two_streams(dev):
    """Two threads on their own streams share one net whose key has a
    graph: each gets its own images' logits, bit-equal to the
    step-by-step forward's."""
    import threading

    from dfq_tpu_torch.engine import Int8FusedNet

    model, residual, size = _lowered("mobilenet_v2_224")
    net = Int8FusedNet(model, device=dev, params_f32=residual)
    rng = np.random.default_rng(5)
    xs = [_t(rng.normal(0, 1, (16, size, size, 3)).astype(np.float32), dev) for _ in range(4)]
    with torch.no_grad():
        wants = [_step_by_step(net, x) for x in xs]
        net(xs[0])
        net(xs[0])
    torch.cuda.synchronize()
    got = {0: [], 1: []}
    errors = []

    def worker(i):
        try:
            stream = torch.cuda.Stream(dev)
            with torch.no_grad(), torch.cuda.stream(stream):
                for r in range(12):
                    k = (2 * i + r) % 4
                    got[i].append((k, net(xs[k])))
            stream.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(net._graphs) == 1
    for i in (0, 1):
        assert len(got[i]) == 12
        for k, out in got[i]:
            _equal(out, wants[k])


@pytest.mark.parametrize("name", sorted(_EPI_MODELS))
def test_profiler_sees_each_kernel_of_a_replay(dev, name):
    """Under ``torch.profiler``, at the cell's batch, the kernels three
    replays run show as device operations, each kernel's (the epilogue's
    too) as many as the lowering's sites times the replays (the
    benchmark's roofline reads them so), inside one ``int8_fused/graph``
    range a forward."""
    from dfq_tpu_torch.engine import Int8FusedNet, int8_fused

    model, residual, size = _lowered(name)
    n = _CELL_BATCH[name]
    net = Int8FusedNet(model, device=dev, params_f32=residual)
    x = _t(np.random.default_rng(9).normal(0, 1, (n, size, size, 3)).astype(np.float32), dev)
    with torch.no_grad():
        net(x)
        net(x)
        torch.cuda.synchronize()
        counts = dict(int8_fused.GRAPH_COUNTS)
        _, calls, prof = _traced_kernels(lambda: [net(x) for _ in range(3)])
    assert {k: v - counts[k] for k, v in int8_fused.GRAPH_COUNTS.items()} == {
        "captures": 0, "replays": 3, "eager": 0}
    ranges = sum(1 for e in prof.events() if e.name == int8_fused.GRAPH
                 and e.device_type == torch.autograd.DeviceType.CPU)
    assert ranges == 3
    low = net.lowering(n)
    assert calls == {**{k: 3 * sum(1 for _, kk, _ in low.kernel_sites if kk == k)
                        for k in ck.LAUNCHES},
                     "conv_epilogue": 3 * len(low.epilogue_sites)}


def test_graph_capture_beside_an_eager_forward_on_another_thread(dev):
    """One net captures and replays its key while a second thread runs
    another net step by step on its own stream, launching throughout the
    capture: both get their step-by-step answers, bit for bit, and the
    second thread's forwards stay out of the graph."""
    import threading

    from dfq_tpu_torch.engine import Int8FusedNet

    model, residual, size = _lowered("mobilenet_v2_224")
    net = Int8FusedNet(model, device=dev, params_f32=residual)
    other = Int8FusedNet(model, device=dev, params_f32=residual)
    rng = np.random.default_rng(11)
    xs = [_t(rng.normal(0, 1, (16, size, size, 3)).astype(np.float32), dev) for _ in range(3)]
    with torch.no_grad():
        wants = [_step_by_step(net, x) for x in xs]
    got, errors, stop = [], [], threading.Event()

    def eager_loop():
        try:
            stream = torch.cuda.Stream(dev)
            with torch.no_grad(), torch.cuda.stream(stream):
                while not stop.is_set():
                    got.append(_step_by_step(other, xs[2]))
            stream.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=eager_loop)
    t.start()
    try:
        with torch.no_grad():
            mine = [net(xs[i % 2]) for i in range(6)]  # eager, capture, 4 replays
            torch.cuda.synchronize()
    finally:
        stop.set()
        t.join()
    assert not errors, errors
    assert len(net._graphs) == 1 and other._graphs == {}
    assert got
    for i, out in enumerate(mine):
        _equal(out, wants[i % 2])
    for out in got:
        _equal(out, wants[2])
