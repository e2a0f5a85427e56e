"""Host-side plans of the redesigned kernels, and the algebra they rely on.

The CUDA kernels run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); what decides how they are launched lives in Python
(``dfq_tpu_torch/ops/cuda_int8.py``) and is held here on the CPU:

- K2's strip variant computes ``sum x t - zp_in * tapsum`` over a halo
  filled with ``zp_in``; ``dw3x3_int8_requant_strip_plain`` writes that in
  plain PyTorch and must equal ``dw3x3_int8_requant_plain`` bit for bit;
  at stride 2 its thread walk (rows loaded, transposes, windows) is
  emulated word by word against the plain product;
- ``matmul_plan`` / ``dw3x3_plan``: every MobileNetV2 main-path site takes
  the fast variant at batch 8 and 128 inside the shared-memory budget,
  ragged or unaligned shapes take the general one, the shared-memory
  layout is aligned and disjoint, the grid covers the work;
- the way the tensor-core variant feeds ``mma.sync.m16n8k32`` (8-byte
  fragment loads, a permutation of k shared by both operands), emulated
  lane by lane in numpy against the plain product;
- K3's ``fused_block_plan`` (variant, chunk width, slabs, column split,
  warp tiles, shared memory) at the 7 main-path shape classes and beside
  them, its launch-argument struct against the source, its packed chunk
  images, its tensor-core variant's algebra emulated block by block in
  numpy against ``fused_block_int8_plain``, and the epilogue helpers it
  adds to ``csrc/int8_epilogue.cuh`` over every rounding tie;
- the plans at the SSD-Lite (300x300) and DeepLab (513x513) sites: K1's
  ``dp4a`` variant where N is not a multiple of 8 (the class heads, the
  segmentation classifier), K2's partial strips, K3's slabs.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from dfq_tpu_torch.ops import cuda_int8 as ck

torch.set_num_threads(1)

# MobileNetV2 224x224 main path: K1 sites as (rows per image, K, N), in
# network order; the last is the classifier (rows = batch, f32 out)
K1_SITES = [
    (112 * 112, 32, 16), (112 * 112, 16, 96), (56 * 56, 96, 24), (56 * 56, 24, 144),
    (28 * 28, 144, 32), (28 * 28, 32, 192), (14 * 14, 192, 64), (14 * 14, 96, 576),
    (7 * 7, 576, 160), (7 * 7, 320, 1280), (1, 1280, 1000),
]
K2_SITE = (112, 112, 32)


def _dw_op(rng, C, zp_in, taps="random", out_f32=False):
    t = (rng.integers(-128, 128, (9, C)) if taps == "random"
         else np.full((9, C), -128)).astype(np.int8)
    return ck.pack_dw3x3(t, rng.uniform(1e-4, 2e-3, C).astype(np.float32),
                         rng.normal(0, 1, C).astype(np.float32), zp_in=zp_in,
                         s_out=0.0193, zp_out=3, out_f32=out_f32, device="cpu")


@pytest.mark.parametrize("taps", ["random", "min"])
@pytest.mark.parametrize("zp_in", [-128, 127, 7])
@pytest.mark.parametrize("shape", [(1, 1, 1, 4), (2, 1, 5, 8), (1, 2, 2, 6), (2, 5, 1, 4),
                                   (1, 7, 9, 32), (2, 2, 7, 20)])
def test_dw3x3_strip_algebra_equals_plain(shape, zp_in, taps):
    rng = np.random.default_rng(sum(shape) + zp_in + 128)
    x = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))
    for out_f32 in (False, True):
        op = _dw_op(rng, shape[-1], zp_in, taps, out_f32)
        got = ck.dw3x3_int8_requant_strip_plain(x, op)
        want = ck.dw3x3_int8_requant_plain(x, op)
        assert got.dtype == want.dtype
        assert torch.equal(got, want)


def test_dw3x3_strip_algebra_at_the_int32_extremes():
    # all inputs and taps at -128 against zp_in = 127: the largest |acc|
    # the kernel can see, 9 * 255 * 128, is far inside int32
    x = torch.full((1, 3, 3, 4), -128, dtype=torch.int8)
    op = _dw_op(np.random.default_rng(0), 4, 127, "min", out_f32=True)
    op.scale.fill_(1.0)
    op.bias.fill_(0.0)
    got = ck.dw3x3_int8_requant_strip_plain(x, op)
    assert torch.equal(got, ck.dw3x3_int8_requant_plain(x, op))
    assert float(got[0, 1, 1, 0]) == 9 * 255 * 128


@pytest.mark.parametrize("zp_in", [-128, -5, 0, 127])
def test_pack_dw3x3_zp_tapsum(zp_in):
    rng = np.random.default_rng(1)
    op = _dw_op(rng, 12, zp_in)
    want = zp_in * op.taps.numpy().astype(np.int64).sum(0)
    assert op.zp_tapsum.dtype == torch.int32
    np.testing.assert_array_equal(op.zp_tapsum.numpy(), want)


@pytest.mark.parametrize("batch,rows", [(1, 2), (8, 4), (32, 14), (128, 14)])
def test_dw3x3_plan_main_path_site_takes_the_strip_variant(batch, rows):
    H, W, C = K2_SITE
    plan = ck.dw3x3_plan(batch, H, W, C)
    assert plan.variant == "strip"
    # tall slabs where the batch alone fills the card, short ones below
    assert plan.rows == rows
    items = -(-H // plan.rows) * -(-W // ck.DW_STRIP) * (C // 4)
    assert (plan.grid[0] - 1) * ck.DW_THREADS < items <= plan.grid[0] * ck.DW_THREADS
    assert plan.grid[1] == batch
    if rows > ck.DW_ROWS[-1]:
        assert items * batch >= ck.H100_SMS * ck.DW_THREADS_PER_SM


@pytest.mark.parametrize("shape,aligned,variant", [
    ((2, 7, 5, 6), True, "general"),  # channels are not whole words
    ((1, 9, 13, 20), True, "strip"),
    ((1, 9, 13, 20), False, "general"),  # an operand off its 16-byte boundary
    ((2, 1, 1, 4), True, "strip"),
    ((70000, 3, 3, 4), True, "strip"),  # more images than grid y holds
    ((1, 3, 3, 3), True, "general"),
])
def test_dw3x3_plan_variant_by_shape_and_alignment(shape, aligned, variant):
    plan = ck.dw3x3_plan(*shape, aligned=aligned)
    assert plan.variant == variant
    assert plan.grid[0] >= 1 and 1 <= plan.grid[1] <= 65535
    if variant == "general":
        assert plan.rows == 0
        assert plan.grid[0] * ck.DW_THREADS >= int(np.prod(shape))
    else:
        assert plan.rows in ck.DW_ROWS
        N, H, W, C = shape
        items = -(-H // plan.rows) * -(-W // ck.DW_STRIP) * (C // 4)
        assert plan.grid[0] * ck.DW_THREADS >= items


# MobileNetV2 224x224's and SSD-Lite 300x300's stride-2 K2 sites (input H = W, C)
K2_S2_SITES = [(112, 96), (56, 144), (28, 192), (14, 576),
               (150, 96), (75, 144), (38, 192), (19, 576), (10, 256), (5, 128), (3, 128),
               (2, 64)]


@pytest.mark.parametrize("batch", [1, 8, 128])
@pytest.mark.parametrize("site", K2_S2_SITES, ids=lambda s: "x".join(map(str, s)))
def test_dw3x3_plan_stride2_sites_take_the_strip_variant(site, batch):
    """Every stride-2 site of the two benchmark models takes the stride-2
    strip variant, its items counted on the output map (odd inputs 75,
    19, 5 and 3 round up), grid y walking the images."""
    H, C = site
    plan = ck.dw3x3_plan(batch, H, H, C, stride=2)
    assert plan.variant == "strip_s2" and plan.rows in ck.DW_ROWS and plan.grid[1] == batch
    OH = -(-H // 2)
    items = -(-OH // plan.rows) * -(-OH // ck.DW_STRIP) * (C // 4)
    assert (plan.grid[0] - 1) * ck.DW_THREADS < items <= plan.grid[0] * ck.DW_THREADS
    assert ck.dw3x3_plan(batch, H, H, C, aligned=False, stride=2).variant == "general_s2"
    general = ck.dw3x3_plan(batch, H, H, 6, stride=2)
    assert general.variant == "general_s2"
    assert general.grid[0] * ck.DW_THREADS >= batch * OH * OH * 6


def _byte_perm(x, y, sel):
    """``__byte_perm`` on uint32 arrays: result byte i is byte
    ``(sel >> 4 i) & 7`` of the 8 bytes (x, y)."""
    both = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint64)
    for i in range(4):
        n = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * n)) & np.uint64(0xff)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _dp4a(a, b, acc):
    a8 = a.astype("<u4").view(np.int8).reshape(a.shape + (4,)).astype(np.int64)
    b8 = b.astype("<u4").view(np.int8).reshape(b.shape + (4,)).astype(np.int64)
    return acc + (a8 * b8).sum(-1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dw3x3_strip_transpose_and_window_plan(seed):
    """The strip kernel's MAC, emulated word by word: six pixel words of 4
    channels are transposed by byte permutes into 4 W-neighbours of one
    channel, a window slides along them by a second permute, and one dp4a
    against (t0, t1, t2, 0) is a 3-tap row sum. Held against the direct
    sum over one input row."""
    rng = np.random.default_rng(seed)
    px = rng.integers(-128, 128, (6, 4)).astype(np.int8)  # pixels w0-1 .. w0+4
    taps = rng.integers(-128, 128, (3, 4)).astype(np.int8)  # [kx, channel]
    p = [px[i].view("<u4").astype(np.uint32) for i in range(6)]
    t0, t1 = _byte_perm(p[0], p[1], 0x5140), _byte_perm(p[2], p[3], 0x5140)
    t2, t3 = _byte_perm(p[0], p[1], 0x7362), _byte_perm(p[2], p[3], 0x7362)
    a = [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
         _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]
    b = [_byte_perm(p[4], p[5], s) for s in (0x0040, 0x0051, 0x0062, 0x0073)]
    tw = [taps[k].view("<u4").astype(np.uint32) for k in range(3)]
    for c in range(4):
        np.testing.assert_array_equal(a[c].view(np.int8), px[:4, c])
        np.testing.assert_array_equal(b[c].view(np.int8)[:2], px[4:, c])
        u = _byte_perm(tw[0], tw[1], c | ((4 + c) << 4))
        tap = _byte_perm(u, tw[2], 0x0010 | ((4 + c) << 8)) & np.uint32(0x00ffffff)
        np.testing.assert_array_equal(tap.view(np.int8), list(taps[:, c]) + [0])
        windows = [a[c]] + [_byte_perm(a[c], b[c], s) for s in (0x4321, 0x5432, 0x6543)]
        for j in range(4):
            want = int((px[j:j + 3, c].astype(np.int64) * taps[:, c].astype(np.int64)).sum())
            assert int(_dp4a(windows[j], tap, 0)[0]) == want
    # the output word: low bytes of four values side by side
    q = [np.array([v], dtype=np.int32).view(np.uint32) for v in (-128, 5, -1, 127)]
    word = _byte_perm(_byte_perm(q[0], q[1], 0x0040), _byte_perm(q[2], q[3], 0x0040), 0x5410)
    np.testing.assert_array_equal(word.view(np.int8), [-128, 5, -1, 127])


def _f32(x):
    return np.asarray(x, np.float32)


def _dw_s2_strip_walk(x, op, rows):
    """The int32 accumulators of ``csrc/dw3x3_int8_requant.cu``'s stride-2
    strip kernel, thread by thread as it computes them: the 9 pixel words
    of each input row it loads (the zero point where its row flag or
    column mask says the pixel is outside), two 4x4 byte transposes, the
    four windows (two of them one byte permute each), one dp4a per window
    and row, and the walk down a slab that keeps input row 2h + 1 as the
    next output row's top."""
    N, H, W, C = x.shape
    CW, OH, OW = C // 4, -(-H // 2), -(-W // 2)
    words = x.numpy().view("<u4").astype(np.uint32)  # [N, H, W, CW]
    tw = op.taps.numpy().view("<u4").astype(np.uint32)  # [9, CW]
    zp4 = np.uint32((op.zp_in & 0xff) * 0x01010101)
    zt = op.zp_tapsum.numpy().reshape(CW, 4)
    out = np.zeros((N, OH, OW, C), np.int64)

    def transpose4(p0, p1, p2, p3):
        t0, t1 = _byte_perm(p0, p1, 0x5140), _byte_perm(p2, p3, 0x5140)
        t2, t3 = _byte_perm(p0, p1, 0x7362), _byte_perm(p2, p3, 0x7362)
        return [_byte_perm(t0, t1, 0x5410), _byte_perm(t0, t1, 0x7632),
                _byte_perm(t2, t3, 0x5410), _byte_perm(t2, t3, 0x7632)]

    for n in range(N):
        for h0 in range(0, OH, rows):
            for w0 in range(0, OW, ck.DW_STRIP):
                cols = [0 <= 2 * w0 - 1 + i < W for i in range(9)]
                for cw in range(CW):
                    def load(r, row_in):
                        return [words[n, r, 2 * w0 - 1 + i, cw:cw + 1] if row_in and cols[i]
                                else np.array([zp4]) for i in range(9)]

                    def transpose(p):
                        return transpose4(*p[:4]), transpose4(*p[4:8]), p[8]

                    taps = []
                    for c in range(4):
                        u = [_byte_perm(tw[3 * ky, cw:cw + 1], tw[3 * ky + 1, cw:cw + 1],
                                        c | ((4 + c) << 4)) for ky in range(3)]
                        taps.append([_byte_perm(u[ky], tw[3 * ky + 2, cw:cw + 1],
                                                0x0010 | ((4 + c) << 8)) & np.uint32(0xffffff)
                                     for ky in range(3)])
                    top = transpose(load(2 * h0 - 1, h0 > 0))
                    even, odd = load(2 * h0, True), load(2 * h0 + 1, 2 * h0 + 1 < H)
                    h_end = min(h0 + rows, OH)
                    for h in range(h0, h_end):
                        mid, bot = transpose(even), transpose(odd)
                        if h + 1 < h_end:
                            even, odd = load(2 * h + 2, True), load(2 * h + 3, 2 * h + 3 < H)
                        for c in range(4):
                            acc = [-int(zt[cw, c])] * 4
                            for ky, (lo, hi, x8) in enumerate((top, mid, bot)):
                                win = [lo[c], _byte_perm(lo[c], hi[c], 0x5432), hi[c],
                                       _byte_perm(hi[c], x8, 0x0032 | ((4 + c) << 8))]
                                acc = [int(_dp4a(win[j], taps[c][ky], acc[j])[0])
                                       for j in range(4)]
                            for j in range(4):
                                if w0 + j < OW:
                                    out[n, h, w0 + j, 4 * cw + c] = acc[j]
                        top = bot
    return out


@pytest.mark.parametrize("rows", [1, 2, 14])
@pytest.mark.parametrize("shape,zp_in", [((1, 7, 9, 8), -128), ((2, 2, 3, 4), 127),
                                         ((1, 6, 17, 4), 0), ((1, 3, 1, 8), -9)],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_dw3x3_s2_strip_walk_equals_plain(shape, zp_in, rows):
    """The stride-2 strip kernel's walk, emulated, gives the plain
    product's accumulators: odd and even sizes, a map narrower than a
    strip, slabs of one row, of two and taller than the map."""
    rng = np.random.default_rng(sum(shape) + rows)
    x = torch.from_numpy(rng.integers(-128, 128, shape).astype(np.int8))
    op = ck.pack_dw3x3(rng.integers(-128, 128, (9, shape[-1])).astype(np.int8),
                       np.ones(shape[-1], np.float32), np.zeros(shape[-1], np.float32),
                       zp_in=zp_in, s_out=0.02, zp_out=0, stride=2, device="cpu")
    want = ck._dw3x3_acc(x.to(torch.int32) - zp_in, op.taps, 2).numpy()
    np.testing.assert_array_equal(_dw_s2_strip_walk(x, op, rows), want)


@pytest.mark.parametrize("act", ["none", "relu", "relu6"])
@pytest.mark.parametrize("s_out,zp_out", [(0.0371, -20), (0.0193, 3), (1e-3, -128),
                                          (2.5, 127), (0.02, 1)])
def test_quant_recip_clamped_equals_quant_recip(act, s_out, zp_out):
    """``quant_recip_clamped`` of ``csrc/int8_epilogue.cuh`` (clip folded
    into integer bounds inside the rounding, rounding by adding 1.5 * 2^23)
    against ``quant_recip(clampf(f, lo, hi))``, both in numpy float32, on
    values at and around every rounding tie and far outside the range."""
    from dfq_tpu_torch.ops.rounding import recip_host

    lo, hi = (_f32(v) for v in ck._ACT[act])
    inv, zp = _f32(recip_host(s_out)), _f32(zp_out)

    def quant_recip(f):
        with np.errstate(over="ignore"):
            q = np.rint(_f32(f * inv)) + zp
        return np.clip(q, _f32(-128), _f32(127)).astype(np.int32)

    rng = np.random.default_rng(7)
    ties = _f32((np.arange(-300, 300) + 0.5) * s_out)
    near = np.concatenate([np.nextafter(ties, _f32(np.inf)), ties,
                           np.nextafter(ties, _f32(-np.inf))])
    f = np.concatenate([near, _f32(rng.normal(0, 3, 4096)), _f32(rng.normal(0, 1e4, 512)),
                        _f32([0.0, -0.0, 6.0, 3.4e38, -3.4e38, 3.4028235e38, -3.4028235e38,
                              np.inf, -np.inf, 1e-45, 2.0 ** 31, -2.0 ** 31])])
    want = quant_recip(np.clip(f, lo, hi))
    # the bounds, once per thread
    b_lo = _f32(quant_recip(lo) - int(zp_out))
    b_hi = _f32(quant_recip(hi) - int(zp_out))
    add = np.int32(int(zp_out) - 0x4B400000)
    with np.errstate(over="ignore"):
        v = np.clip(_f32(f * inv), b_lo, b_hi)
    got = _f32(v + _f32(12582912.0)).view(np.int32) + add
    np.testing.assert_array_equal(got, want)


def _check_mma_plan(plan, M, K, N, out_f32):
    es = 4 if out_f32 else 1
    Np = -(-N // 8) * 8  # the packed weight's rows
    assert plan.variant == "mma"
    assert plan.smem <= ck.SMEM_BUDGET
    assert plan.bn % 8 == 0 and 8 <= plan.bn <= max(ck.MM_MAX_BN, 8)
    assert 1 <= plan.stages <= ck.MM_MAX_STAGES
    # rows: K padded to the MMA's depth, pitch 32 mod 64 (conflict-free loads)
    assert plan.pitch % 64 == 32 and plan.pitch >= -(-K // 32) * 32
    assert plan.pitch == ck.matmul_pitch(K)
    # w rows and the ring are one array of rows; regions aligned, disjoint
    assert plan.off_x == plan.bn * plan.pitch
    assert plan.off_o == plan.off_x + plan.stages * ck.MM_TILE_M * plan.pitch
    assert plan.opitch >= plan.bn * es and plan.opitch % 8 == 0
    if out_f32 or (N % 16 == 0 and plan.bn % 16 == 0):
        assert plan.opitch % 16 == 0  # the tile is stored in 16-byte pieces
    if N != Np:  # rows of any width: staged at their destination's address mod 16
        assert plan.opitch % 16 == 0 and plan.opitch >= plan.bn * es + 16
    assert plan.off_o % 16 == 0 and plan.off_c % 16 == 0
    assert plan.off_c >= plan.off_o + ck.MM_TILE_M * plan.opitch
    assert plan.smem == plan.off_c + 12 * plan.bn
    # the grid: column tiles cover Np, row walkers never outnumber row tiles
    gx, gy = plan.grid
    m_tiles = -(-M // ck.MM_TILE_M)
    assert gy == -(-Np // plan.bn) and (gy - 1) * plan.bn < N
    assert 1 <= gx <= m_tiles
    per_sm = min(ck.MM_BLOCKS_PER_SM,
                 ck.SMEM_PER_SM // (plan.smem + ck.SMEM_PER_BLOCK_RESERVED))
    assert gx * gy <= max(gy, ck.H100_SMS * per_sm)  # persistent: one wave


def _check_stream_plan(plan, M, K, N, out_f32):
    """The streamed variant's plan: what its entry point checks, and the
    choices of ``_stream_plan``."""
    es = 4 if out_f32 else 1
    Np = -(-N // 8) * 8
    assert plan.variant == "stream"
    assert plan.bn % 8 == 0 and 8 <= plan.bn <= ck.MM_STREAM_BN and plan.bn == min(64, Np)
    # as few 16-row strips as cover M; the other warps split the slices
    assert plan.wr in (1, 2, 4, 8) and plan.wr * plan.wk == 8
    assert plan.wr == 1 or 16 * (plan.wr // 2) < M
    assert plan.ks % 32 == 0 and plan.ks // 32 >= plan.wk
    assert plan.pitch % 64 == 32 and plan.pitch == plan.ks + 32
    tm = 16 * plan.wr
    assert plan.off_w == tm * plan.pitch and plan.stage == (tm + plan.bn) * plan.pitch
    assert 2 <= plan.stages <= ck.MM_STREAM_MAX_STAGES
    red = (plan.wk - 1) * plan.wr * (ck.MM_STREAM_BN // 8) * 512
    assert plan.off_o % 16 == 0 and plan.off_o >= max(plan.stages * plan.stage, red)
    assert plan.opitch % 16 == 0 and plan.opitch >= plan.bn * es + 16
    assert plan.smem == plan.off_o + tm * plan.opitch
    assert plan.smem + ck.SMEM_PER_BLOCK_RESERVED <= ck.SMEM_PER_SM // 2  # 2 blocks an SM
    # blocks: row tiles x column tiles, then K parts that cover K once
    tiles = -(-M // tm) * -(-Np // plan.bn)
    gx, gy, parts = plan.grid
    assert gx == tiles and gy == 1
    assert plan.kchunk % plan.ks == 0 and (parts - 1) * plan.kchunk < K <= parts * plan.kchunk
    if tiles >= ck.H100_SMS:
        assert parts == 1
    else:  # K parts fill the SMs idle tiles leave, one wave
        assert tiles * parts <= 2 * ck.H100_SMS
        assert parts == -(-K // plan.ks) or tiles * (parts + 1) > 2 * ck.H100_SMS - tiles


def _check_plan(plan, M, K, N, out_f32):
    if plan.variant == "mma":
        _check_mma_plan(plan, M, K, N, out_f32)
    else:
        _check_stream_plan(plan, M, K, N, out_f32)


@pytest.mark.parametrize("batch", [8, 128])
@pytest.mark.parametrize("site", K1_SITES, ids=lambda s: "x".join(map(str, s)))
def test_matmul_plan_main_path_sites_take_the_mma_variant(site, batch):
    rows, K, N = site
    out_f32 = N == 1000
    _check_mma_plan(ck.matmul_plan(rows * batch, K, N, out_f32), rows * batch, K, N, out_f32)


@pytest.mark.parametrize("shape", [(777, 16, 96), (200001, 16, 96), (129, 1280, 1000),
                                   (70, 48, 40), (1, 8, 8), (3, 24, 144), (50, 1400, 8)])
@pytest.mark.parametrize("out_f32", [False, True])
def test_matmul_plan_other_aligned_shapes(shape, out_f32):
    M, K, N = shape
    _check_mma_plan(ck.matmul_plan(M, K, N, out_f32), M, K, N, out_f32)


@pytest.mark.parametrize("shape,aligned,variant", [
    ((301, 27, 19), True, "dp4a"), ((5, 3, 2), True, "dp4a"),
    ((64, 8, 12), True, "mma"),  # N padded to 16 in the packed weight
    ((64, 12, 8), True, "dp4a"),
    ((70, 48, 40), False, "dp4a"),  # x or w off its 16-byte boundary
    ((64, 4096, 64), True, "stream"),  # one tile of x does not fit shared memory
])
def test_matmul_plan_general_variant(shape, aligned, variant):
    """dp4a is left with K not a multiple of 8 (or under 8) and unaligned
    operands; a ragged N and a long K take the tensor cores."""
    plan = ck.matmul_plan(*shape, aligned=aligned)
    if variant == "dp4a":
        assert plan == ck.MatmulPlan("dp4a")
    else:
        assert plan.variant == variant
        _check_plan(plan, *shape, False)


def test_matmul_plan_streams_whole_rows_at_the_large_sites():
    # N <= MM_MAX_BN and many row tiles: one column tile, so x is read once,
    # with enough x in flight; few row tiles: columns split over the SMs
    for rows, K, N in K1_SITES[:7]:
        plan = ck.matmul_plan(rows * 128, K, N)
        assert plan.grid[1] == 1 and plan.bn == N
        assert (plan.stages - 1) * ck.MM_TILE_M * K >= min(ck.MM_INFLIGHT, 7 * 128 * K)
    cls = ck.matmul_plan(128, 1280, 1000, True)
    assert cls.grid[0] == 1 and cls.grid[1] >= 100
    assert ck.matmul_plan(128, 1280, 1000, True, sms=8).grid[1] < cls.grid[1]


@pytest.mark.parametrize("K", sorted({k for _, k, _ in K1_SITES} | {8, 40, 64, 128, 1400}))
def test_matmul_pitch_keeps_fragment_loads_off_shared_banks(K):
    # a half-warp's 8-byte loads: rows r..r+3, byte offsets 8 * tig; the 16
    # loads must cover 32 different 4-byte banks
    pitch = ck.matmul_pitch(K)
    banks = {((r * pitch + 8 * t + 4 * h) // 4) % 32
             for r in range(4) for t in range(4) for h in range(2)}
    assert len(banks) == 32


def test_mma_fragment_plan_equals_the_plain_product():
    """Lane (g, t) loads bytes [8t, 8t+8) of rows g and g+8 of x and of
    row g of w; the halves go to the instruction's registers a0/a2, a1/a3
    and b0/b1, whose k-slots are [4t, 4t+4) and [16+4t, 16+4t+4). Both
    operands are permuted alike, so D = A . B^T; lane (g, t) receives rows
    g, g+8 and columns 2t, 2t+1."""
    rng = np.random.default_rng(0)
    A = rng.integers(-128, 128, (16, 32)).astype(np.int64)
    B = rng.integers(-128, 128, (8, 32)).astype(np.int64)
    hwA = np.zeros_like(A)  # what the instruction sees at (row, k-slot)
    hwB = np.zeros_like(B)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        lo, hi = A[g, 8 * t:8 * t + 8], A[g + 8, 8 * t:8 * t + 8]
        b = B[g, 8 * t:8 * t + 8]
        hwA[g, 4 * t:4 * t + 4], hwA[g, 16 + 4 * t:20 + 4 * t] = lo[:4], lo[4:]  # a0, a2
        hwA[g + 8, 4 * t:4 * t + 4], hwA[g + 8, 16 + 4 * t:20 + 4 * t] = hi[:4], hi[4:]  # a1, a3
        hwB[g, 4 * t:4 * t + 4], hwB[g, 16 + 4 * t:20 + 4 * t] = b[:4], b[4:]  # b0, b1
    D = hwA @ hwB.T
    np.testing.assert_array_equal(D, A @ B.T)
    out = np.zeros((16, 8), np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for h in range(2):  # c[2h], c[2h+1]: row g + 8h, columns 2t, 2t+1
            out[g + 8 * h, 2 * t:2 * t + 2] = D[g + 8 * h, 2 * t:2 * t + 2]
    np.testing.assert_array_equal(out, A @ B.T)


def test_matmul_args_layout_matches_the_source():
    # 6 pointers, 28 four-byte fields, then the workspace pointer, no
    # padding: MatmulLaunch in csrc/matmul_int8_requant.cu, whose first 128
    # bytes are MatmulArgs, the resident variant's kernel parameter
    assert ctypes.sizeof(ck._MatmulArgs) == 6 * 8 + 28 * 4 + 8
    assert ck._MatmulArgs.Np.offset == 128
    names = [n for n, _ in ck._MatmulArgs._fields_]
    assert names[:6] == ["x", "w", "scale", "bias", "wsum", "out"]
    assert names[6:15] == ["M", "N", "K", "zp_in", "inv", "zp_out", "lo", "hi", "out_f32"]
    assert names[15:] == ["variant", "bn", "stages", "pitch", "opitch", "off_x", "off_o",
                          "off_c", "smem", "grid_x", "grid_y", "Np", "grid_z", "ks", "wr", "wk",
                          "kchunk", "stage", "off_w", "ws"]
    assert ck.MM_VARIANTS == ("dp4a", "mma", "stream")


@pytest.mark.parametrize("shape", [(4, 8), (24, 144), (576, 160)])
def test_pack_words_roundtrip(shape):
    w = torch.from_numpy(np.random.default_rng(sum(shape)).integers(
        -128, 128, shape).astype(np.int8))
    words = ck._pack_words(w)
    assert words.dtype == torch.int32 and tuple(words.shape) == (shape[0] // 4, shape[1])
    assert torch.equal(ck._unpack_words(words), w)


def test_variant_counts_reset_with_the_launch_counts():
    ck.reset_counts()
    assert ck.VARIANTS == {"matmul_int8_requant": {"mma": 0, "stream": 0, "dp4a": 0},
                           "dw3x3_int8_requant": {"strip": 0, "general": 0, "strip_s2": 0,
                                                  "general_s2": 0},
                           "fused_block_int8": {"mma": 0, "general": 0}}
    ck._count_launch("matmul_int8_requant", "mma")
    ck._count_launch("fused_block_int8", "general")
    assert ck.LAUNCHES == {"matmul_int8_requant": 1, "dw3x3_int8_requant": 0,
                           "fused_block_int8": 1}
    assert ck.VARIANTS["matmul_int8_requant"] == {"mma": 1, "stream": 0, "dp4a": 0}
    assert ck.VARIANTS["fused_block_int8"] == {"mma": 0, "general": 1}
    ck.reset_counts()
    assert ck.LAUNCHES["matmul_int8_requant"] == 0
    assert ck.VARIANTS["matmul_int8_requant"]["mma"] == 0
    assert ck.VARIANTS["fused_block_int8"]["general"] == 0


# ---------------------------------------------------------------------------
# K3: the tensor-core variant's plan, packing and algebra

# MobileNetV2 224x224 main path: the 7 shape classes of K3 as (H = W, C, E, C2)
K3_SITES = [(56, 24, 144, 24), (28, 32, 192, 32), (14, 64, 384, 64), (14, 64, 384, 96),
            (14, 96, 576, 96), (7, 160, 960, 160), (7, 160, 960, 320)]


def _check_fused_plan(plan, N, H, W, C, E, C2):
    assert plan.variant == "mma"
    assert plan.smem <= ck.SMEM_BUDGET
    # chunks of E, rows padded to 8 pixels, pitches of 32 mod 64 bytes
    assert plan.ec % 32 == 0 and plan.nk * plan.ec >= E > (plan.nk - 1) * plan.ec
    assert plan.wx % 8 == 0 and 0 <= plan.wx - W < 8
    assert plan.wp == plan.wx + 12 and (plan.wp // 4) % 2 == 1
    assert plan.p1 == ck.matmul_pitch(C) and plan.p2 == ck.matmul_pitch(plan.ec)
    # the slabs cover every row once
    assert 1 <= plan.bh <= ck.FB_MAX_ROWS
    n_h = -(-H // plan.bh)
    assert (n_h - 1) * plan.bh < H <= n_h * plan.bh
    assert plan.grid[0] == N * n_h
    # the blocks of one slab cover every column once
    csplit = plan.grid[1]
    assert (csplit - 1) * plan.ntb * 8 < C2 <= csplit * plan.ntb * 8
    # the warps' tiles cover the block's, inside the register budget
    assert plan.mt * 16 >= plan.bh * plan.wx
    assert (plan.wm, plan.wn) in ck.FB_WARP_TILES
    assert ck.FB_WARPS % plan.wgm == 0
    assert plan.wgm * plan.wm >= plan.mt
    assert (ck.FB_WARPS // plan.wgm) * plan.wn >= plan.ntb
    # accumulators: at most 48 of a thread's 128 registers
    assert plan.acc_regs == 4 * plan.wm * plan.wn <= 48
    # shared memory: aligned, disjoint, two weight buffers at the end
    ec, nk, p1, p2, img_c, img_w2, stride = ck.fused_block_image(C, E, C2)
    assert (ec, nk) == (plan.ec, plan.nk)
    assert img_c == ec * p1 and img_w2 == img_c + 36 * ec and stride == img_w2 + C2 * p2
    for off in (plan.off_e, plan.off_d, plan.off_w, plan.wbuf, img_c, img_w2, stride):
        assert off % 16 == 0
    assert plan.off_e >= (plan.bh + 2) * plan.wx * plan.p1
    assert plan.off_d - plan.off_e >= (plan.bh + 3) * plan.ec * plan.wp
    assert plan.off_t - plan.off_d >= plan.mt * 16 * plan.p2
    assert plan.off_t % 16 == 0
    items = -(-(plan.bh + 2) * plan.wx // 8 // ck.FB_EXPAND_TILES)
    assert plan.off_w - plan.off_t >= items * ck.FB_EXPAND_TILES * 4
    # the table's entry holds the e-tile offset in 20 bits, the x tile in 10
    assert (plan.bh + 3) * plan.ec * plan.wp < 1 << 20 and (plan.bh + 2) * plan.wx // 8 < 1 << 10
    assert plan.ec in (32, 64, 128)
    assert plan.wbuf == img_w2 + plan.ntb * 8 * plan.p2
    # the staged project output lies over all of it after the last chunk
    assert plan.fpitch % 32 == 8 and plan.fpitch >= plan.ntb * 8
    staged = plan.bh * W * plan.fpitch * 4
    assert plan.smem == max(plan.off_w + 2 * plan.wbuf, -(-staged // 16) * 16)
    assert 1 <= plan.dr <= plan.bh


@pytest.mark.parametrize("N", [1, 3, 8, 128])
@pytest.mark.parametrize("site", K3_SITES, ids=lambda s: "x".join(map(str, s)))
def test_fused_block_plan_main_path_sites_take_the_mma_variant(site, N):
    H, C, E, C2 = site
    plan = ck.fused_block_plan(N, H, H, C, E, C2)
    _check_fused_plan(plan, N, H, H, C, E, C2)
    assert ck.fused_block_fits(H, H, C, E, C2)
    if N == 128:  # the batch alone fills the card: the tallest slabs that fit
        assert plan.grid[1] == 1 and 4 * plan.grid[0] >= 3 * ck.H100_SMS
        assert plan.bh == min(H, ck.FB_MAX_ROWS)
    if N <= 8:  # small batch: shorter slabs or split columns make more blocks
        big = ck.fused_block_plan(128, H, H, C, E, C2)
        assert plan.bh <= big.bh and plan.grid[0] * plan.grid[1] * 128 >= big.grid[0] * N


@pytest.mark.parametrize("shape", [(2, 10, 10, 24, 144, 24), (1, 13, 13, 32, 192, 64),
                                   (3, 9, 5, 8, 4, 8), (1, 1, 1, 16, 96, 16),
                                   (2, 17, 60, 24, 144, 24), (1, 5, 300, 8, 48, 8)])
def test_fused_block_plan_other_aligned_shapes(shape):
    N, H, W, C, E, C2 = shape
    _check_fused_plan(ck.fused_block_plan(N, H, W, C, E, C2), N, H, W, C, E, C2)


@pytest.mark.parametrize("shape,aligned", [
    ((2, 10, 10, 12, 72, 12), True),  # C, C2 multiples of 4 but not of 8
    ((2, 10, 10, 24, 144, 20), True),
    ((2, 10, 10, 4, 24, 8), True),
    ((2, 10, 10, 24, 144, 24), False),  # x or out off its 16-byte boundary
    ((1, 4, 1100, 8, 48, 8), True),  # one row of pixels is more than a block's tiles
])
def test_fused_block_plan_general_variant(shape, aligned):
    assert ck.fused_block_plan(*shape, aligned=aligned) == ck.FusedBlockPlan("general")


def test_fused_block_fits_means_k3_runs_the_block():
    # either variant: channels that are whole words
    assert ck.fused_block_fits(10, 10, 12, 72, 12)  # general
    assert ck.fused_block_fits(10, 10, 24, 144, 24)  # mma
    assert not ck.fused_block_fits(14, 14, 6, 36, 6)
    # a shape whose whole-E tile would not fit one row, taken in chunks
    assert ck.fused_block_smem(1, 56, 320, 1920) > ck.SMEM_BUDGET
    assert ck.fused_block_fits(56, 56, 320, 1920, 320)


@pytest.mark.parametrize("shape", [(n, *s[:1], *s) for s in K3_SITES for n in (1, 8, 128)]
                         + [(2, 10, 10, 24, 144, 24), (1, 5, 300, 8, 48, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_fused_block_plan_is_a_candidate(shape):
    """The planner only chooses (slab rows, column split); the plan itself
    is ``fused_block_candidate``'s, which measurements force directly."""
    N, H, W, C, E, C2 = shape
    plan = ck.fused_block_plan(N, H, W, C, E, C2)
    assert plan == ck.fused_block_candidate(N, H, W, C, E, C2, plan.bh, plan.grid[1])


@pytest.mark.parametrize("shape,bh,csplit", [
    ((8, 56, 56, 24, 144, 24), 4, 4),  # 3 column tiles over 4 blocks: the last has none
    ((8, 7, 7, 160, 960, 320), 7, 64),
    ((8, 7, 7, 160, 960, 320), 7, 0),
    ((8, 7, 7, 160, 960, 320), 0, 1),  # no row
    ((8, 7, 7, 160, 960, 320), 8, 1),  # taller than the image
    ((8, 56, 56, 24, 144, 24), 15, 1),  # taller than FB_MAX_ROWS
    ((8, 10, 10, 12, 72, 12), 2, 1),  # channels not multiples of 8
    ((1, 4, 1100, 8, 48, 8), 1, 1),  # no warp tiling
    ((1, 56, 56, 320, 1920, 320), 14, 1),  # neither tiles nor shared memory
])
def test_fused_block_candidate_refuses_what_the_kernel_cannot_run(shape, bh, csplit):
    assert ck.fused_block_candidate(*shape, bh, csplit) is None


@pytest.mark.parametrize("shape,bh,csplit", [((8, 56, 56, 24, 144, 24), 4, 3),
                                             ((8, 7, 7, 160, 960, 320), 7, 4),
                                             ((128, 14, 14, 96, 576, 96), 2, 2)])
def test_fused_block_candidate_forced_plans_hold_the_invariants(shape, bh, csplit):
    plan = ck.fused_block_candidate(*shape, bh, csplit)
    assert (plan.bh, plan.grid[1]) == (bh, csplit)
    _check_fused_plan(plan, *shape)


@pytest.mark.parametrize("case", ["unaligned", "floor off the zero point"])
def test_fused_block_args_name_a_shape_only_the_mma_variant_holds(case):
    """56x56x320->1920: ``fused_block_fits`` says K3 runs it, in chunks.
    Off a 16-byte boundary (or with an activation floor that is not the
    zero point) only the general variant is left, whose one-row tile is
    over the budget: the wrapper says so before it touches the card."""
    op = _block_op(np.random.default_rng(5), 320, 1920, 320, res=True, req_c1=False,
                   req_r=False, out_f32=False)
    assert ck.fused_block_fits(56, 56, 320, 1920, 320)
    assert ck.fused_block_smem(1, 56, 320, 1920) > ck.SMEM_BUDGET
    aligned = case != "unaligned"
    if aligned:
        op.lo_e -= 1.0
    with pytest.raises(ValueError, match="runs only in the tensor-core variant"):
        ck._fused_block_args(op, 1, 56, 56, aligned)
    assert not op.launch_args


def test_fused_block_warp_tiles_match_the_source():
    """``FB_WARP_TILES``, ``FB_WARPS`` and ``FB_EXPAND_TILES`` against the
    template instances (``DFQ_LAUNCH``), ``NW`` and ``EXP_NT`` of
    ``csrc/fused_block_int8.cu``: a plan with another warp tile would be
    refused by the launcher on the card only."""
    import re
    from pathlib import Path

    src = (Path(ck.__file__).resolve().parents[1] / "csrc" / "fused_block_int8.cu").read_text()
    code = "\n".join(line.split("//")[0] for line in src.splitlines())
    instances = [(int(m), int(n)) for m, n in re.findall(r"^\s*DFQ_LAUNCH\((\d+),\s*(\d+)\)",
                                                          code, re.M)]
    assert instances and tuple(instances) == ck.FB_WARP_TILES
    assert [int(v) for v in re.findall(r"constexpr int NW = (\d+);", code)] == [ck.FB_WARPS]
    assert [int(v) for v in re.findall(r"constexpr int EXP_NT = (\d+);", code)] \
        == [ck.FB_EXPAND_TILES]


def test_fused_block_args_layout_matches_the_source():
    """``_FusedBlockArgs`` against ``struct FusedBlockArgs`` of
    ``csrc/fused_block_int8.cu``, field by field: name, order and type."""
    import re
    from pathlib import Path

    src = (Path(ck.__file__).resolve().parents[1] / "csrc" / "fused_block_int8.cu").read_text()
    body = src[src.index("struct FusedBlockArgs {"):]
    body = body[:body.index("};")]
    fields = []
    for line in body.splitlines()[1:]:
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        m = re.match(r"(const\s+)?(\w+)\s*(\*?)\s*(.+)", line)
        ctype = ctypes.c_void_p if m.group(3) else {"int": ctypes.c_int,
                                                    "float": ctypes.c_float}[m.group(2)]
        fields += [(n.strip(), ctype) for n in m.group(4).split(",")]
    assert [(n, t) for n, t in ck._FusedBlockArgs._fields_] == fields
    # 15 pointers, then 4-byte fields, no padding but the tail's (to 8 bytes)
    assert ctypes.sizeof(ck._FusedBlockArgs) == -(-(15 * 8 + (len(fields) - 15) * 4) // 8) * 8


def _block_op(rng, C, E, C2, *, res, req_c1, req_r, out_f32, zp_e=-128, zp_d=-128):
    w1 = rng.integers(-128, 128, (C, E)).astype(np.int8)
    w2 = rng.integers(-128, 128, (E, C2)).astype(np.int8)
    x_grid = (0.0412, -9)
    return ck.pack_fused_block(
        w1, rng.uniform(1e-4, 5e-4, E).astype(np.float32),
        rng.normal(0, 0.5, E).astype(np.float32), w1.astype(np.int32).sum(0),
        rng.integers(-128, 128, (9, E)).astype(np.int8),
        rng.uniform(1e-3, 4e-3, E).astype(np.float32),
        rng.normal(0, 0.5, E).astype(np.float32),
        w2, rng.uniform(1e-5, 1e-4, C2).astype(np.float32),
        rng.normal(0, 0.5, C2).astype(np.float32), w2.astype(np.int32).sum(0),
        x_grid=x_grid, c1_grid=(0.0377, 4) if req_c1 else x_grid, e_grid=(0.0213, zp_e),
        d_grid=(0.0531, zp_d), act1_hi=3.4e38, act2_hi=6.0,
        res_grid=((0.0450, -2) if req_r else x_grid) if res else None,
        p_grid=(0.0301, 5) if res else None,
        out_grid=None if out_f32 else (0.0622, -1), device="cpu")


def _fma32(a, b, c):
    # one rounding of a * b + c: the product of two f32 is exact in f64
    return (np.asarray(a, np.float64) * np.float64(b) + np.float64(c)).astype(np.float32)


def _quant_u8_clamped(f, r, zp128, lo, hi):
    """``quant_u8_clamped`` of ``csrc/int8_epilogue.cuh`` in numpy float32."""
    b_lo, b_hi = _f32(lo) - _f32(zp128), _f32(hi) - _f32(zp128)
    add = np.int32(int(zp128) - 128 - 0x4B400000)
    with np.errstate(over="ignore", invalid="ignore"):
        v = np.fmin(np.fmax(_f32(_f32(f) * _f32(r)), b_lo), b_hi)
    return _f32(v + _f32(12582912.0)).view(np.int32) + add


def _quant_relu(f, r, zp128, hi):
    """``quant_relu`` of ``csrc/int8_epilogue.cuh`` in numpy float32: a
    saturating multiply by r / 256, an FMA with 256 and 1.5 * 2^23, an
    integer minimum, an integer add."""
    r256 = _f32(_f32(r) * _f32(2.0 ** -8))
    assert np.float64(r256) * 256 == np.float64(_f32(r))  # the scaling is exact
    with np.errstate(over="ignore", invalid="ignore", under="ignore"):
        prod = _f32(_f32(f) * r256)
    s = np.where(np.isnan(prod), _f32(0), np.clip(prod, _f32(0), _f32(1)))  # mul.rn.sat.f32
    t = (s.astype(np.float64) * 256 + 12582912.0).astype(np.float32).view(np.int32)
    top = np.int32(0x4B400000 + int(hi) - int(zp128))
    return np.minimum(t, top) + np.int32(int(zp128) - 128 - 0x4B400000)


def _requant_clamped(q, zp_from, ratio, zp_to128):
    r = np.clip(_fma32(_f32(q.astype(np.int32) - zp_from), _f32(ratio), _f32(zp_to128)),
                _f32(0), _f32(255))
    return _f32(r + _f32(12582912.0)).view(np.int32) - np.int32(0x4B400000 + 128)


def _emulate_fused_block_mma(x, op, plan):
    """The tensor-core variant of ``csrc/fused_block_int8.cu`` block by
    block in numpy, from the packed chunk images: the staged x slab with
    its pitches and padding, the E-chunk loop, the e tile
    ``[row][channel][wp]`` with its zp_e padding, the strip windows (byte
    permutes) and 3-tap ``dp4a``, the d tile, the project accumulators
    over the chunks, and the clamped quantizers."""
    N, H, W, C = x.shape
    C2, ec, wx, wp, p1, p2, bh = op.C2, plan.ec, plan.wx, plan.wp, plan.p1, plan.p2, plan.bh
    _, nk, _, _, img_c, img_w2, stride = ck.fused_block_image(C, op.E, C2)
    img = op.wimg.numpy().reshape(nk, stride)
    zw2 = op.zw2.numpy().astype(np.int64)
    sc2, b2 = op.sc2.numpy(), op.b2.numpy()
    out = np.zeros((N, H, W, C2), np.float32 if op.out_f32 else np.int8)
    R, S = bh + 2, -(-W // 4)
    kp = -(-C // 32) * 32
    for n in range(N):
        for r0 in range(0, H, bh):
            xs = np.zeros((R * wx, p1), np.int8)
            for r in range(R):
                h = r0 - 1 + r
                if 0 <= h < H:
                    v = x[n, h]
                    if op.req_c1:
                        v = _requant_clamped(v, op.zp_x, op.ratio_c1, op.zp_c1 + 128)
                    xs[r * wx:r * wx + W, :C] = v
            es = np.full((R, ec, wp), op.zp_e & 0xff, np.uint8)
            ds = np.zeros((plan.mt * 16, p2), np.int8)
            acc = np.tile(-zw2, (plan.mt * 16, 1))
            for k in range(nk):
                w1s = img[k, :img_c].reshape(ec, p1)
                consts = img[k, img_c:img_w2].copy().view(np.int32).reshape(9, ec)
                sc1, b1, scd, bd = (consts[i].view(np.float32) for i in (0, 1, 3, 4))
                zw1, ztd, taps = consts[2], consts[5], consts[6:9]
                w2s = img[k, img_w2:].reshape(C2, p2)
                # expand: [channel, pixel], K padded to the MMA's depth
                a1 = (w1s[:, :kp].astype(np.int64) @ xs[:, :kp].astype(np.int64).T
                      - zw1[:, None].astype(np.int64))
                f1 = _fma32(a1.astype(np.float32), sc1[:, None], b1[:, None])
                assert op.lo_e == op.zp_e + 128 and op.lo_d == op.zp_d + 128
                q1 = _quant_relu(f1, op.r_e, op.zp_e + 128, op.hi_e)
                q1 = q1.reshape(ec, R, wx)
                for r in range(R):  # rows outside the image keep zp_e; no tile is made
                    if 0 <= r0 - 1 + r < H:  # pixels W .. wx - 1: values of no meaning
                        es[r, :, 4:4 + wx] = q1[:, r, :].astype(np.int8).view(np.uint8)
                # depthwise: words at pixels 4s-4, 4s, 4s+4 -> 4 windows -> dp4a
                words = es.view("<u4")  # [R][ec][wp / 4]
                for rr in range(min(bh, H - r0)):
                    for s in range(S):
                        v = np.tile(-ztd.astype(np.int64), (4, 1))  # [j][channel]
                        # pixel W reads as zp_e: byte W % 4 of word 1 + W / 4
                        keep, put = [0xffffffff] * 2, [0, 0]
                        if W < wx:
                            m = 0xff << (8 * (W & 3))
                            zpe4 = (op.zp_e & 0xff) * 0x01010101
                            for i in range(2):
                                if s + i == W // 4:
                                    keep[i], put[i] = ~m & 0xffffffff, zpe4 & m
                        for ky in range(3):
                            w0, w1_, w2_ = (words[rr + ky, :, s + i] for i in range(3))
                            w1_ = (w1_ & np.uint32(keep[0])) | np.uint32(put[0])
                            w2_ = (w2_ & np.uint32(keep[1])) | np.uint32(put[1])
                            win = [_byte_perm(w0, w1_, 0x6543), w1_,
                                   _byte_perm(w1_, w2_, 0x4321), _byte_perm(w1_, w2_, 0x5432)]
                            for j in range(4):
                                v[j] = _dp4a(win[j], taps[ky].view(np.uint32), v[j])
                        fd = _fma32(v.astype(np.float32), scd[None], bd[None])
                        qd = _quant_relu(fd, op.r_d, op.zp_d + 128, op.hi_d)
                        ds[rr * wx + 4 * s:rr * wx + 4 * s + 4, :ec] = qd.astype(np.int8)
                # project: all ec bytes of K (the padded channels meet zero rows)
                acc = acc + ds[:, :ec].astype(np.int64) @ w2s[:, :ec].astype(np.int64).T
            f2 = _fma32(acc.astype(np.float32), sc2[None], b2[None])
            for p in range(plan.mt * 16):
                rr, w = divmod(p, wx)
                h = r0 + rr
                if rr >= bh or h >= H or w >= W:
                    continue
                f = f2[p]
                if op.res:
                    q2 = _quant_u8_clamped(f, op.r_p, op.zp_p + 128, 0, 255)
                    bf = _fma32(_f32(q2), op.s_p, op.c_p)
                    xq = x[n, h, w].astype(np.int32)
                    if op.req_r:
                        xq = _requant_clamped(xq, op.zp_x, op.ratio_r, op.zp_r + 128)
                    f = _fma32(_f32(xq), op.s_r, op.c_r) + bf
                out[n, h, w] = f if op.out_f32 else _quant_u8_clamped(
                    f, op.r_o, op.zp_o + 128, 0, 255).astype(np.int8)
    return out


@pytest.mark.parametrize("flags", [(True, True, True, False), (True, False, False, True),
                                   (False, True, False, False), (False, False, False, True),
                                   (True, False, True, True), (True, True, False, False)],
                         ids=lambda f: "res%d-reqc1%d-reqr%d-f32%d" % tuple(map(int, f)))
@pytest.mark.parametrize("shape", [(2, 10, 10, 24, 144), (1, 7, 7, 32, 192), (1, 13, 9, 40, 100)])
def test_fused_block_mma_algebra_equals_plain(shape, flags):
    """E = 144 and 100 pad to whole chunks with zero channels, C = 24 and
    40 pad K to 32 and 64, 10 and 13 rows leave ragged last slabs, the
    first and last slabs have halo rows outside the image."""
    res, req_c1, req_r, out_f32 = flags
    N, H, W, C, E = shape
    rng = np.random.default_rng(sum(shape))
    C2 = C if res else C + 8
    op = _block_op(rng, C, E, C2, res=res, req_c1=req_c1, req_r=req_r, out_f32=out_f32,
                   zp_e=-128 if C == 24 else -77, zp_d=-128 if C == 24 else 19)
    x = rng.integers(-128, 128, (N, H, W, C)).astype(np.int8)
    want = ck.fused_block_int8_plain(torch.from_numpy(x), op).numpy()
    for batch in (N, 128):  # the small-batch plan and the tall-slab plan
        plan = ck.fused_block_plan(batch, H, W, C, E, C2)
        assert plan.variant == "mma"
        got = _emulate_fused_block_mma(x, op, plan)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def test_fused_block_image_pads_e_with_harmless_channels():
    rng = np.random.default_rng(5)
    C, E, C2 = 24, 144, 24
    op = _block_op(rng, C, E, C2, res=False, req_c1=False, req_r=False, out_f32=False)
    ec, nk, p1, p2, img_c, img_w2, stride = ck.fused_block_image(C, E, C2)
    assert (ec, nk) == (32, 5) and nk * ec - E == 16
    last = op.wimg.numpy().reshape(nk, stride)[-1]
    pad = slice(E - (nk - 1) * ec, ec)  # the padded channels of the last chunk
    assert not last[:img_c].reshape(ec, p1)[pad].any()
    assert not last[img_c:img_w2].copy().view(np.int32).reshape(9, ec)[:, pad].any()
    assert not last[img_w2:].reshape(C2, p2)[:, pad].any()
    # and the real channels are the operands': w1 rows, w2 columns, taps
    w1 = ck._unpack_words(op.w1).numpy()
    w2 = ck._unpack_words(op.w2).numpy()
    img = op.wimg.numpy().reshape(nk, stride)
    for k in range(nk):
        n = min(ec, E - k * ec)
        np.testing.assert_array_equal(img[k, :img_c].reshape(ec, p1)[:n, :C],
                                      w1[:, k * ec:k * ec + n].T)
        np.testing.assert_array_equal(img[k, img_w2:].reshape(C2, p2)[:, :n],
                                      w2[k * ec:k * ec + n].T)
        taps = img[k, img_c + 24 * ec:img_w2].reshape(3, ec, 4)
        np.testing.assert_array_equal(
            taps[:, :n, :3], op.wd.numpy()[:, k * ec:k * ec + n].reshape(3, 3, n).transpose(0, 2, 1))
        assert not taps[..., 3].any()
    np.testing.assert_array_equal(op.zw2.numpy(), op.zp_d * op.ws2.numpy())


@pytest.mark.parametrize("zp,lo,hi", [(-128, None, 127), (-128, None, -15), (-77, None, 127),
                                      (19, None, 100), (5, -128, 127), (-128, -128, 127),
                                      (127, -128, 127), (127, None, 127)])
@pytest.mark.parametrize("s", [0.0213, 0.0531, 1e-3, 2.5])
def test_quant_u8_clamped_equals_quant_u8(s, zp, lo, hi):
    """``quant_u8_clamped`` against ``quant_u8`` (both of
    ``csrc/int8_epilogue.cuh``, in numpy float32) at and around every
    rounding tie, at both bounds and far outside; ``lo=None`` is K3's
    activation floor ``zp``, ``(-128, 127)`` its project and output form."""
    from dfq_tpu_torch.ops.rounding import recip_xla

    lo = zp if lo is None else lo
    r, zp128, lo128, hi128 = _f32(recip_xla(s)), _f32(zp + 128), _f32(lo + 128), _f32(hi + 128)
    rng = np.random.default_rng(11)
    ties = _f32((np.arange(-300, 300) + 0.5) * s)
    near = np.concatenate([np.nextafter(ties, _f32(np.inf)), ties,
                           np.nextafter(ties, _f32(-np.inf))])
    f = np.concatenate([near, _f32(rng.normal(0, 3, 4096)), _f32(rng.normal(0, 1e4, 512)),
                        _f32([0.0, -0.0, 6.0, 3.4e38, -3.4e38, np.inf, -np.inf, np.nan, 1e-45,
                              2.0 ** 23 * s, -2.0 ** 23 * s, 2.0 ** 24 * s, 2.0 ** 31,
                              -2.0 ** 31])])
    with np.errstate(over="ignore", invalid="ignore"):
        q = np.rint(_f32(f * r)) + zp128
        want = np.fmin(np.fmax(q, lo128), hi128).astype(np.int32) - 128
    np.testing.assert_array_equal(_quant_u8_clamped(f, r, zp + 128, lo + 128, hi + 128), want)
    if lo == zp:  # the grids with an activation floor at 0 also take quant_relu
        tiny = _f32([2.0 ** -126 * s, -(2.0 ** -126) * s, 2.0 ** -140, 255.5 * s, 256.0 * s,
                     256.5 * s, 1e30])
        g = np.concatenate([f, tiny])
        with np.errstate(over="ignore", invalid="ignore"):
            q = np.rint(_f32(g * r)) + zp128
            want_g = np.fmin(np.fmax(q, lo128), hi128).astype(np.int32) - 128
        np.testing.assert_array_equal(_quant_relu(g, r, zp + 128, hi + 128), want_g)
    # the torch form the plain version uses agrees wherever f is a number
    ok = ~np.isnan(f)
    plain = ck.quant_u8(torch.from_numpy(f[ok]), float(r), zp, float(lo128), float(hi128))
    np.testing.assert_array_equal(plain.numpy(), want[ok])


@pytest.mark.parametrize("bound", [2 ** 22 - 1, 255 * 128 * 128, 9 * 255 * 128])
def test_magic_number_accumulators_convert_exactly(bound):
    """An int32 accumulator that starts at the bit pattern of 1.5 * 2^23
    holds, for every |sum| < 2^22, the float 1.5 * 2^23 + sum, so that one
    float subtraction is the int -> float conversion (K3's depthwise: 9
    taps of 255 * 128; its expand up to C = 128: 255 * 128 * C)."""
    assert bound < 2 ** 22
    rng = np.random.default_rng(bound)
    sums = np.concatenate([rng.integers(-bound, bound + 1, 4096),
                           [-bound, bound, 0, 1, -1]]).astype(np.int32)
    bits = (np.int32(0x4B400000) + sums).view(np.float32)
    np.testing.assert_array_equal(_f32(bits - _f32(12582912.0)), sums.astype(np.float32))


@pytest.mark.parametrize("ratio,zp_from,zp_to", [(1.0928, -9, 4), (0.9156, -9, -2),
                                                 (3.7, 127, -128), (0.01, -128, 127)])
def test_requant_clamped_equals_requant(ratio, zp_from, zp_to):
    from dfq_tpu_torch.ops.rounding import requant_i8

    q = np.arange(-128, 128).astype(np.int8)
    want = requant_i8(torch.from_numpy(q), zp_from, float(_f32(ratio)), zp_to).numpy()
    got = _requant_clamped(q, zp_from, ratio, zp_to + 128)
    np.testing.assert_array_equal(got, want.astype(np.int32))


@pytest.mark.parametrize("W", [7, 14, 28, 56, 10, 13])
def test_fused_block_tile_layouts_equal_the_plain_product(W):
    """The expand as the kernel lays it out: channels are the MMA's M and
    pixels its N, so lane (g, t) of tile (mt, nt) holds channels 16 mt + g
    and + 8 of pixels 8 nt + 2 t and + 1, two W-neighbours that go as one
    16-bit store to byte 4 + w of e-tile row (r, channel); an 8-pixel tile
    never crosses an image row because rows are staged wx pixels apart.
    Pixels W .. wx - 1 get values of no meaning. The depthwise then finds
    pixel w - 1 .. w + 1 of a strip in three words, with zp_e patched into
    the place of pixel W, and the bank of a lane's word is its channel's
    (odd word pitch)."""
    rng = np.random.default_rng(W)
    ec, R = 32, 3
    wx, wp = -(-W // 8) * 8, -(-W // 8) * 8 + 12
    e_true = rng.integers(-128, 128, (R, ec, W)).astype(np.int8)  # what the GEMM yields
    es = np.full((R, ec, wp), 0x55, np.uint8)
    es[:, :, :4] = es[:, :, 4 + wx:] = 0x80
    for nt in range(R * wx // 8):
        r, w0 = divmod(nt * 8, wx)
        for mte in range(ec // 16):
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                w = w0 + 2 * t
                for h2 in range(2):
                    c = mte * 16 + g + 8 * h2
                    pair = [e_true[r, c, w + i] if w + i < W else 0x33 for i in range(2)]
                    assert (4 + w) % 2 == 0  # the 16-bit store is aligned
                    es[r, c, 4 + w:6 + w] = np.array(pair, np.int8).view(np.uint8)
    np.testing.assert_array_equal(es[:, :, 4:4 + W].view(np.int8), e_true)
    assert (es[:, :, :4] == 0x80).all() and (es[:, :, 4 + wx:] == 0x80).all()
    words = es.view("<u4")
    for s in range(-(-W // 4)):
        w0, w1, w2 = (words[1, :, s + i].copy() for i in range(3))
        if W < wx:
            m = np.uint32(0xff << (8 * (W & 3)))
            if s == W // 4:
                w1 = (w1 & ~m) | (np.uint32(0x80808080) & m)
            if s + 1 == W // 4:
                w2 = (w2 & ~m) | (np.uint32(0x80808080) & m)
        win = [_byte_perm(w0, w1, 0x6543), w1, _byte_perm(w1, w2, 0x4321),
               _byte_perm(w1, w2, 0x5432)]
        padded = np.full((ec, W + 2 + 8), -128, np.int8)
        padded[:, 1:W + 1] = e_true[1]
        for j in range(4):
            if 4 * s + j < W:
                got = np.ascontiguousarray(win[j]).view(np.int8).reshape(ec, 4)[:, :3]
                np.testing.assert_array_equal(got, padded[:, 4 * s + j:4 * s + j + 3])
    # 32 lanes = 32 consecutive channels of one strip: 32 different banks
    assert len({(c * wp // 4) % 32 for c in range(32)}) == 32


# ---------------------------------------------------------------------------
# the detection and segmentation paths: SSD-Lite 300x300, DeepLab-v3+
# MobileNetV2 513x513

# SSD-Lite's K1 sites as (rows per image, K, N, f32 out), in network order
SSD_K1_SITES = [
    (150 * 150, 32, 16, False), (150 * 150, 16, 96, False), (75 * 75, 96, 24, False),
    (75 * 75, 24, 144, False), (38 * 38, 144, 32, False), (38 * 38, 32, 192, False),
    (19 * 19, 192, 64, False), (19 * 19, 96, 576, False), (10 * 10, 576, 160, False),
    (10 * 10, 320, 1280, False), (10 * 10, 1280, 256, False), (5 * 5, 256, 512, False),
    (5 * 5, 512, 128, False), (3 * 3, 128, 256, False), (3 * 3, 256, 128, False),
    (2 * 2, 128, 256, False), (2 * 2, 256, 64, False), (1, 64, 64, False),
] + [(hw * hw, k, n, True) for hw, k in ((19, 576), (10, 1280), (5, 512), (3, 256), (2, 256),
                                         (1, 64)) for n in (126, 24)]
# its K2 sites (H = W, C) and K3 shape classes (H = W, C, E, C2)
SSD_K2_SITES = [(150, 32), (19, 576), (10, 1280), (5, 512), (3, 256), (2, 256)]
SSD_K3_SITES = [(75, 24, 144, 24), (38, 32, 192, 32), (19, 64, 384, 64), (19, 64, 384, 96),
                (19, 96, 576, 96), (10, 160, 960, 160), (10, 160, 960, 320)]
# DeepLab's K1 shape classes (rows per image, K, N): the pointwise convs
# after an explicit pad take the padded map; the last is the classifier
DEEPLAB_K1_SITES = [
    (257 * 257, 32, 16), (259 * 259, 16, 96), (129 * 129, 96, 24), (131 * 131, 24, 144),
    (129 * 129, 144, 24), (65 * 65, 144, 32), (67 * 67, 32, 192), (65 * 65, 192, 32),
    (33 * 33, 192, 64), (35 * 35, 64, 384), (33 * 33, 384, 64), (33 * 33, 384, 96),
    (35 * 35, 96, 576), (33 * 33, 576, 96), (33 * 33, 576, 160), (35 * 35, 160, 960),
    (33 * 33, 960, 160), (37 * 37, 160, 960), (33 * 33, 960, 320), (33 * 33, 320, 256),
    (1, 320, 256), (33 * 33, 1280, 256), (129 * 129, 24, 48), (129 * 129, 256, 21),
]


@pytest.mark.parametrize("batch", [3, 8, 128])
@pytest.mark.parametrize("site", SSD_K1_SITES, ids=lambda s: "x".join(map(str, s[:3])))
def test_matmul_plan_ssd_sites(site, batch):
    """Every SSD-Lite K1 site takes the tensor-core variant, the six class
    heads too: their N = 6 * 21 = 126 is padded to 128 in the packed
    weight, and their rows of 126 bytes are stored at any byte width."""
    rows, K, N, out_f32 = site
    _check_mma_plan(ck.matmul_plan(rows * batch, K, N, out_f32), rows * batch, K, N, out_f32)


@pytest.mark.parametrize("batch", [3, 4, 8])
@pytest.mark.parametrize("site", DEEPLAB_K1_SITES, ids=lambda s: "x".join(map(str, s)))
def test_matmul_plan_deeplab_sites(site, batch):
    """DeepLab's 38 K1 launches, all tensor-core, the classifier (N = 21,
    padded to 24) too: from batch 3 its block holds all 21 columns, so a
    warp's 16 rows are one run of 336 bytes."""
    rows, K, N = site
    plan = ck.matmul_plan(rows * batch, K, N)
    _check_mma_plan(plan, rows * batch, K, N, False)
    if N == 21:
        assert plan.bn == 24 and plan.grid[1] == 1


@pytest.mark.parametrize("batch", [3, 8, 128])
@pytest.mark.parametrize("site", SSD_K2_SITES, ids=lambda s: "x".join(map(str, s)))
def test_dw3x3_plan_ssd_sites(site, batch):
    """K2's strip variant at every SSD-Lite site, its 4-pixel strips
    partial at W = 150, 19, 10, 5, 3 and 2 (the last strip of a row)."""
    H, C = site
    plan = ck.dw3x3_plan(batch, H, H, C)
    assert plan.variant == "strip" and plan.rows in ck.DW_ROWS and plan.grid[1] == batch
    items = -(-H // plan.rows) * -(-H // ck.DW_STRIP) * (C // 4)
    assert (plan.grid[0] - 1) * ck.DW_THREADS < items <= plan.grid[0] * ck.DW_THREADS
    if H > 2:
        assert H % ck.DW_STRIP  # a partial strip at the row's end


@pytest.mark.parametrize("N", [1, 3, 8, 128])
@pytest.mark.parametrize("site", SSD_K3_SITES, ids=lambda s: "x".join(map(str, s)))
def test_fused_block_plan_ssd_sites(site, N):
    """K3 takes the tensor-core variant at every SSD-Lite block; its row
    pitch rounds 75/38/19/10 up to a multiple of 8. At batch 8 the slabs
    are 6, 3, 2 and 2 rows high: the last slab of 75, 38 and 19 is short."""
    H, C, E, C2 = site
    plan = ck.fused_block_plan(N, H, H, C, E, C2)
    _check_fused_plan(plan, N, H, H, C, E, C2)
    assert ck.fused_block_fits(H, H, C, E, C2)
    assert plan.wx == -(-H // 8) * 8
    if N == 8:
        assert plan.bh == {75: 6, 38: 3, 19: 2, 10: 2}[H]
        assert (H % plan.bh != 0) == (H != 10)


# MobileNetV1's K3 blocks (H = W, C, E, C2): its pw -> dw s1 -> pw chains in
# the MobileNetV1-SSD backbones at 300x300 (blocks 2-3, 4-5, 6-7, 8-9 and
# 10-11, 12-13)
MB1_K3_SITES = [(75, 64, 128, 128), (38, 128, 256, 256), (19, 256, 512, 512),
                (19, 512, 512, 512), (10, 512, 1024, 1024)]


@pytest.mark.parametrize("N", [1, 3, 8, 10, 128])
@pytest.mark.parametrize("site", MB1_K3_SITES, ids=lambda s: "x".join(map(str, s)))
def test_fused_block_plan_mobilenet_v1_sites(site, N):
    """The tensor-core variant at every batch. At C2 = 1024 no slab holds
    all the output columns, so they are shared by 2 or 4 blocks at every
    batch, also where the batch alone fills the card (from batch 10)."""
    H, C, E, C2 = site
    plan = ck.fused_block_plan(N, H, H, C, E, C2)
    _check_fused_plan(plan, N, H, H, C, E, C2)
    assert plan == ck.fused_block_candidate(N, H, H, C, E, C2, plan.bh, plan.grid[1])
    if C2 == 1024:
        assert ck.fused_block_candidate(N, H, H, C, E, C2, 1, 1) is None
        assert plan.grid[1] in (2, 4)


# the zoo's K1 shape classes that only the dp4a variant took before N was
# padded and long K streamed, (rows per
# image, K, N): AlexNet's classifier (K 9216 and 4096 after the flatten),
# a K of 2048 (Xception's ASPP, DRN's layer6 and ResNet-101's layer4 at
# DeepLab 513x513), N = 126 at MobileNetV1-SSD-Lite's and
# SqueezeNet-SSD-Lite's class heads
ZOO_DP4A_SITES = [(1, 9216, 4096), (1, 4096, 4096), (1, 4096, 1000), (33 * 33, 2048, 256),
                  (65 * 65, 2048, 512), (33 * 33, 2048, 512), (19 * 19, 512, 126),
                  (10 * 10, 1024, 126), (17 * 17, 512, 126)]


@pytest.mark.parametrize("batch", [1, 3, 8, 128])
@pytest.mark.parametrize("site", ZOO_DP4A_SITES, ids=lambda s: "x".join(map(str, s)))
def test_matmul_plan_zoo_sites_on_the_tensor_cores(site, batch):
    """The resident variant stages whole 128-row tiles of x in shared
    memory, so a K past ~1.8k cannot take it (one tile of K = 2048 is 266
    KB): those sites take the streamed variant, whose slices of K keep
    int32 accumulators in registers (|sum| <= K * 2^14 < 2^31 at K = 9216).
    The heads' N = 126 take the resident variant on a padded weight. At
    a batch-row GEMV one 16-row strip takes all 8 warps, which split K,
    and K is also split over the blocks that 64 column tiles leave idle."""
    rows, K, N = site
    M = rows * batch
    head = N % 8 != 0  # a class head: f32 out
    plan = ck.matmul_plan(M, K, N, head)
    assert K * 128 * 128 < 2**31
    if not head:
        assert ck.MM_TILE_M * ck.matmul_pitch(K) > ck.SMEM_BUDGET
        _check_stream_plan(plan, M, K, N, False)
        if M <= 16:
            assert plan.wr == 1 and plan.wk == 8
        if N == 4096 and M <= 128:
            assert plan.grid == (64, 1, 4)
    else:
        _check_mma_plan(plan, M, K, N, True)


# the resident plans as matmul_plan made them before N was padded and
# long K streamed (N a multiple of 8): every shape they took keeps its plan
def _resident_plan_before(M, K, N, out_f32, sms=ck.H100_SMS):
    if M < 1 or K < 8 or N < 8 or K % 8 or N % 8:
        return None
    pitch = ck.matmul_pitch(K)
    m_tiles = -(-M // 128)
    n_split = -(-N // 256)
    if m_tiles * n_split < sms:
        n_split = max(n_split, min(N // 8, -(-sms // m_tiles)))
    bn = -(-(-(-N // n_split)) // 8) * 8
    stages = min(8, max(2, -(-16384 // (128 * K)) + 1))

    def layout(bn, stages):
        opitch = bn * (4 if out_f32 else 1) + 16
        off_x = bn * pitch
        off_o = off_x + stages * 128 * pitch
        off_c = off_o + -(-128 * opitch // 16) * 16
        return opitch, off_x, off_o, off_c, off_c + 12 * bn

    while layout(bn, stages)[-1] > 232448:
        if stages > 1:
            stages -= 1
        elif bn > 8:
            bn = max(8, bn // 16 * 8)
        else:
            return None
    opitch, off_x, off_o, off_c, smem = layout(bn, stages)
    n_tiles = -(-N // bn)
    per_sm = max(1, min(3, 233472 // (smem + 1024)))
    return dict(bn=bn, stages=stages, pitch=pitch, opitch=opitch, off_x=off_x, off_o=off_o,
                off_c=off_c, smem=smem,
                grid=(min(m_tiles, max(1, sms * per_sm // n_tiles)), n_tiles))


@pytest.mark.parametrize("path", ["mobilenet_v2", "ssd_lite", "deeplab"])
def test_matmul_plan_resident_sites_unchanged(path):
    sites = {"mobilenet_v2": [(r, k, n, n == 1000) for r, k, n in K1_SITES],
             "ssd_lite": SSD_K1_SITES,
             "deeplab": [(r, k, n, False) for r, k, n in DEEPLAB_K1_SITES]}[path]
    n = 0
    for rows, K, N, out_f32 in sites:
        for batch in (1, 3, 4, 8, 128):
            want = _resident_plan_before(rows * batch, K, N, out_f32)
            if want is None:
                continue
            plan = ck.matmul_plan(rows * batch, K, N, out_f32)
            assert plan == ck.MatmulPlan("mma", **want), (rows, K, N, batch)
            n += 1
    assert n == {"mobilenet_v2": 55, "ssd_lite": 120, "deeplab": 115}[path]


# ---------------------------------------------------------------------------
# the store of rows at any byte width and the streamed variant, emulated

def _staged_row(g, r, whole, row_bytes, opitch):
    """``staged_row`` of ``csrc/matmul_int8_requant.cu``: where row r of a
    warp's rows is staged; ``g`` is the warp's first output byte address."""
    return (g & 15) + r * row_bytes if whole else r * opitch + ((g + r * row_bytes) & 15)


def _store_runs(out, base, g, gstride, s, sstride, nrun, length, writes):
    """``store_runs`` lane by lane: run i from staging ``s`` (a numpy byte
    array at a 16-byte boundary) to byte address ``g + i * gstride`` of
    ``out`` (whose byte 0 is at address ``base``); counts every byte
    written in ``writes`` and checks that each 16-byte piece is aligned on
    both sides."""
    for i in range(nrun):
        gi = g + i * gstride
        sh = gi & 15
        si = i * sstride + sh
        head = min(length, (16 - sh) & 15)
        body = (length - head) >> 4
        tail = (length - head) & 15
        for lane in range(32):
            if lane < head:
                out[gi - base + lane] = s[si + lane]
                writes[gi - base + lane] += 1
            for p in range(lane, body, 32):
                a = head + 16 * p
                assert (gi + a) % 16 == 0 and (si + a) % 16 == 0
                out[gi - base + a:gi - base + a + 16] = s[si + a:si + a + 16]
                writes[gi - base + a:gi - base + a + 16] += 1
            if lane < tail:
                a = head + 16 * body + lane
                out[gi - base + a] = s[si + a]
                writes[gi - base + a] += 1


@pytest.mark.parametrize("es", [1, 4])
@pytest.mark.parametrize("N", [1, 3, 21, 126, 1000])
@pytest.mark.parametrize("M", [1, 16, 37])
def test_store_walk_writes_each_output_byte_once(M, N, es):
    """A warp stages its rows' real columns (``stage_pair``: single stores,
    never the pad columns) at their destination's address mod 16 and
    stores them with ``store_runs``: one run of rows * N * ES bytes where
    the block holds all N columns, else a run a row. Exactly M * N * ES
    bytes are written, each once with its value, none outside the rows;
    the staged rows of a strip (all 16, past M too) stay in the warp's
    16 * opitch bytes."""
    Np = -(-N // 8) * 8
    rng = np.random.default_rng(M + N + es)
    want = rng.integers(0, 256, M * N * es, dtype=np.uint8)
    row_bytes = N * es
    base = 4096 + 16 * 3  # the allocation's address: 16-byte aligned
    for bn in sorted({Np, min(Np, 64), 8}):
        opitch = ck._ragged_opitch(bn, es == 4)
        guard = 64
        out = np.zeros(M * row_bytes + 2 * guard, np.uint8)
        writes = np.zeros_like(out, dtype=np.int64)
        for n0 in range(0, Np, bn):
            nvr = min(bn, N - n0)
            whole = n0 == 0 and nvr == N
            for m0 in range(0, M, 16):
                rows = min(16, M - m0)
                g = base + (m0 * N + n0) * es
                stage = np.zeros(16 * opitch, np.uint8)
                for r in range(16):
                    ro = _staged_row(g, r, whole, row_bytes, opitch)
                    for c in range(nvr):  # real columns only
                        at = ro + c * es
                        assert at + es <= stage.size
                        if r < rows:
                            v = want[((m0 + r) * N + n0 + c) * es:((m0 + r) * N + n0 + c + 1) * es]
                            stage[at:at + es] = v
                _store_runs(out[guard:], base, g, row_bytes, stage, opitch,
                            1 if whole else rows, rows * row_bytes if whole else nvr * es,
                            writes[guard:])
        assert (writes[:guard] == 0).all() and (writes[guard + M * row_bytes:] == 0).all()
        assert (writes[guard:guard + M * row_bytes] == 1).all(), bn
        np.testing.assert_array_equal(out[guard:guard + M * row_bytes], want)


def _emulate_stream_sums(x, w, plan):
    """The streamed variant's int32 sums of ``x [M, K] . w [Np, K]^T``,
    block by block as ``mm_stream_kernel`` forms them: slices of ``ks``
    bytes within each block's K part (zeros past K), the slice's 32-byte
    steps dealt to the strip's K warps, their partial sums added in the
    first, the K parts added into the workspace (int32, wrapping as the
    hardware does). Returns ``(sums [M, Np], cover)``: ``cover[t, k]``
    counts the times tile t's warps took byte k of K."""
    M, K = x.shape
    Np = w.shape[0]
    tm, bn = 16 * plan.wr, plan.bn
    n_tiles = -(-Np // bn)
    tiles, _, parts = plan.grid
    ws = np.zeros((M, Np), np.int32)
    cover = np.zeros((tiles, K), np.int64)
    for b in range(tiles):
        mt, nt = divmod(b, n_tiles)
        m0, n0 = mt * tm, nt * bn
        nv = min(bn, Np - n0)
        for z in range(parts):
            k_beg = z * plan.kchunk
            k_end = min(K, k_beg + plan.kchunk)
            partial = np.zeros((plan.wk, tm, nv), np.int32)
            for i in range(-(-(k_end - k_beg) // plan.ks)):
                k0 = k_beg + i * plan.ks
                xs = np.zeros((tm, plan.ks), np.int64)  # the stage, zero-filled
                ws_ = np.zeros((nv, plan.ks), np.int64)
                kk = min(k_end, k0 + plan.ks) - k0
                xs[:max(0, min(tm, M - m0)), :kk] = x[m0:m0 + tm, k0:k0 + kk]
                ws_[:, :kk] = w[n0:n0 + nv, k0:k0 + kk]
                for kg in range(plan.wk):
                    for step in range(kg, plan.ks // 32, plan.wk):
                        k = slice(32 * step, 32 * step + 32)
                        partial[kg] += (xs[:, k] @ ws_[:, k].T).astype(np.int32)
                        cover[b, k0 + 32 * step:min(k_end, k0 + 32 * step + 32)] += 1
            acc = partial.sum(0, dtype=np.int32)  # the K warps, in shared memory
            rows = max(0, min(tm, M - m0))
            ws[m0:m0 + rows, n0:n0 + nv] += acc[:rows]  # atomicAdd
    return ws, cover


@pytest.mark.parametrize("M,K,N", [(8, 9216, 4096), (1, 4096, 1000), (37, 2048, 126),
                                   (17, 4096, 21), (300, 2048, 64), (8, 9216, 1)])
def test_split_k_plan_covers_k_once_and_sums_exactly(M, K, N):
    """The streamed plan at the GEMV and K = 2048 shapes: every tile's
    warps take each byte of K exactly once over its K parts, and the int32
    partial sums add to the exact product. Operands at the extremes
    (-128 x -128 everywhere) give the largest sum, K * 2^14 = 1.5e8 at
    K = 9216, inside int32; random ones check the indexing. The large
    shapes are cut to their first column tiles (the same plan)."""
    plan = ck.matmul_plan(M, K, N)
    assert plan.variant == "stream"
    _check_stream_plan(plan, M, K, N, False)
    Np = -(-N // 8) * 8
    n_cols = min(Np, 2 * plan.bn)  # two column tiles are enough to index
    cut = dataclasses.replace(plan, grid=(-(-M // (16 * plan.wr)) * -(-n_cols // plan.bn), 1,
                                          plan.grid[2]))
    rng = np.random.default_rng(M + K + N)
    for fill in ("extreme", "random"):
        if fill == "extreme":
            x = np.full((M, K), -128, np.int64)
            w = np.full((n_cols, K), -128, np.int64)
        else:
            x = rng.integers(-128, 128, (M, K))
            w = rng.integers(-128, 128, (n_cols, K))
        if n_cols > N:  # the pad rows of the packed weight
            w[N:] = 0
        sums, cover = _emulate_stream_sums(x, w, cut)
        assert (cover == 1).all()
        want = x @ w.T
        assert np.abs(want).max() < 2**31
        np.testing.assert_array_equal(sums.astype(np.int64), want)
        if fill == "extreme":
            assert int(want.max()) == K * 2**14
