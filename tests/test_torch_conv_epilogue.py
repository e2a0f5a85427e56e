"""The glue convs' epilogue (``dfq_tpu_torch/ops/conv_epilogue.py``) on
the CPU:

- its plain version equals the fused engine's former torch epilogue
  (the conv step's ``acc - zp * wsum``, f32 cast, ``fma_f32`` or product,
  then ``_emit``'s quantize; on the float routes ``_conv_valid``'s int32
  NHWC copy first) bit for bit, with and without a bias, onto int8 codes
  and f32, on int32 rows with a padded pitch and on float NCHW conv
  outputs, at the int32 and f32-exact extremes, on .5 ties and at both
  clamp ends;
- the CUDA kernel's launch plan (variant, block, grid) for the layouts
  the product routes leave, and that its grid covers every output once;
- ``Int8FusedNet`` on the CPU, under ``plain_kernels`` and under
  ``use_kernels=False`` gives the logits of the same net with the former
  epilogue for MobileNetV2 and ResNet-18 at 32x32 b2, with no launch
  counted and one plain run a glue conv step on the CPU's wrapper;
- the kernel's device functions match none of the benchmark's kernel
  names (it is glue, timed in ``glue_ms_per_image``).

The kernel against its plain version on the card: ``tests/test_torch_cuda.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import dfq_tpu_torch.engine.int8_fused as tf
from dfq_tpu_torch.engine import Int8FusedNet, lower_int8
from dfq_tpu_torch.models import init_params, mobilenet_v2, resnet18
from dfq_tpu_torch.ops import conv_epilogue as cep
from dfq_tpu_torch.ops import cuda_int8 as ck
from dfq_tpu_torch.ops.rounding import fma_f32
from dfq_tpu_torch.pipeline import QuantConfig, prepare

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def former_epilogue(acc, op):
    """The fused engine's conv-step epilogue before it moved into
    ``ops/conv_epilogue.py``, as it read there."""
    if acc.is_floating_point():  # engine/int8.py:_conv_valid on a float route
        acc = acc.to(torch.int32).permute(0, 2, 3, 1).contiguous()
    a = (acc - op.zp * op.wsum).to(torch.float32)
    out = a * op.comb if op.bias is None else fma_f32(a, op.comb, op.bias)
    return out if op.grid is None else tf._quantize_f32(out, op.grid[0], op.grid[1])


C = 20  # not a multiple of 8: the int32 rows carry a padded pitch (24)
B, H, W = 2, 3, 5


def _site(bias: bool, out_i8: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    wsum = rng.integers(-30000, 30000, C).astype(np.int32)
    comb = rng.uniform(1e-5, 3e-3, C).astype(np.float32)
    b = rng.normal(0, 2, C).astype(np.float32)
    # channel 0 lands on .5 ties: f = a / 2 (+ 1) onto a grid of scale 1
    comb[0], b[0], wsum[0] = 0.5, 1.0, 0
    return cep.pack_conv_epilogue(wsum, comb, b if bias else None, zp=-7,
                                  grid=(1.0, 3) if out_i8 else None, device="cpu")


def _acc_values(n: int, lim: int, seed: int) -> np.ndarray:
    """Accumulator values: the extremes of +-lim, small values (ties,
    both clamp ends of the quantize) and random ones."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-lim, lim, n, dtype=np.int64)
    v[:6] = [-lim, lim - 1, -1, 1, 255, -255]
    v[6:40] = np.arange(-17, 17)
    return v


def _acc(layout: str):
    """An accumulator of [B, H, W, C] as a product route leaves it."""
    if layout == "int32_pitch":  # torch._int_mm's [M, Np] rows, sliced
        rows = torch.from_numpy(_acc_values(B * H * W * 24, 2**31, 1).astype(np.int32))
        return rows.view(B * H * W, 24)[:, :C].reshape(B, H, W, C)
    dtype = {"f32_nchw": torch.float32, "f64_nchw": torch.float64}[layout]
    # the float routes' values are exact integers, |acc| <= 2^24
    vals = torch.from_numpy(_acc_values(B * C * H * W, 2**24 + 1, 2).astype(np.float64))
    return vals.to(dtype).view(B, C, H, W)


@pytest.mark.parametrize("layout", ["int32_pitch", "f32_nchw", "f64_nchw"])
@pytest.mark.parametrize("out_i8", [True, False], ids=["int8", "f32"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_plain_equals_the_former_epilogue(layout, out_i8, bias):
    op = _site(bias, out_i8)
    acc = _acc(layout)
    got = cep.conv_epilogue_plain(acc, op)
    want = former_epilogue(acc, op)
    assert got.dtype == (torch.int8 if out_i8 else torch.float32)
    assert got.shape == (B, H, W, C) and got.is_contiguous()
    assert torch.equal(got, want)
    if out_i8:
        assert got.min() == -128 and got.max() == 127  # both clamp ends reached


def test_plain_rounds_ties_to_even():
    """Channel 0: f = a / 2 + 1 on a grid of scale 1 and zero point 3."""
    op = _site(True, True)
    a = torch.arange(-9, 10, dtype=torch.int32)
    acc = torch.zeros(1, 1, a.numel(), C, dtype=torch.int32)
    acc[0, 0, :, 0] = a
    got = cep.conv_epilogue_plain(acc, op)[0, 0, :, 0].to(torch.int64)
    want = np.clip(np.round(a.numpy() / 2 + 1) + 3, -128, 127)  # numpy rounds half to even
    assert got.tolist() == want.tolist()


def test_the_wrapper_runs_the_plain_version_on_the_cpu():
    op = _site(True, True)
    acc = _acc("f64_nchw")
    cep.reset_counts()
    got = cep.conv_epilogue_packed(acc, op)
    assert (cep.EPILOGUE_LAUNCHES, cep.EPILOGUE_PLAIN_CALLS) == (0, 1)
    assert torch.equal(got, cep.conv_epilogue_plain(acc, op))
    cep.reset_counts()
    assert (cep.EPILOGUE_LAUNCHES, cep.EPILOGUE_PLAIN_CALLS) == (0, 0)


def _layout_strides(b: int, h: int, w: int, c: int, layout: str, pitch: int):
    """The logical NHWC strides a product route leaves its accumulator in."""
    return {"int32_pitch": (h * w * pitch, w * pitch, pitch, 1),  # _int_mm rows, sliced
            "f32_nchw": (c * h * w, w, 1, h * w),  # a cuDNN conv's NCHW output
            "f32_cl": (h * w * c, w * c, c, 1)}[layout]  # ... or its channels-last one


def test_layout_strides_are_the_tensors():
    b, h, w, c = 2, 3, 5, 20
    rows = torch.zeros(b * h * w, 24, dtype=torch.int32)[:, :c].reshape(b, h, w, c)
    nchw = torch.zeros(b, c, h, w)
    for t, layout in ((rows, "int32_pitch"), (nchw, "f32_nchw"),
                      (nchw.to(memory_format=torch.channels_last), "f32_cl")):
        assert cep._nhwc_view(t, c).stride() == _layout_strides(b, h, w, c, layout, 24)


@pytest.mark.parametrize("case,variant", [
    ((128, 56, 56, 64, "int32_pitch", 64), "rows_vec"),   # ResNet-18's layer1 on _int_mm
    ((32, 129, 129, 256, "int32_pitch", 256), "rows_vec"),  # DeepLab's decoder
    ((4, 7, 7, 21, "int32_pitch", 24), "rows"),            # ragged channels
    ((2, 9, 9, 32, "f32_nchw", 32), "rows"),              # NCHW: strided channels
    ((128, 112, 112, 32, "f32_cl", 32), "rows_vec"),
])
def test_launch_plan_by_layout(case, variant):
    b, h, w, c, layout, pitch = case
    strides = _layout_strides(b, h, w, c, layout, pitch)
    plan = cep.conv_epilogue_plan(b, h, w, c, strides)
    assert plan.variant == variant
    tx, ty = plan.block
    assert tx * ty <= cep.EPI_THREADS and plan.grid[0] >= 1 and plan.grid[1] >= 1
    assert plan.grid[0] * plan.grid[1] <= ck.H100_SMS * cep.EPI_BLOCKS_PER_SM
    # rows off their 16-byte boundaries take the scalar variant
    assert cep.conv_epilogue_plan(b, h, w, c, strides, aligned=False).variant == "rows"


def _covered(plan, b: int, h: int, w: int, c: int) -> np.ndarray:
    """How many times the kernel's threads, walking ``plan``'s grid as the
    CUDA source does, write each output element [B*H*W, C]."""
    hits = np.zeros((b * h * w, c), np.int64)
    P = b * h * w
    tx, ty = plan.block
    groups = -(-c // cep.EPI_GROUP)
    for gy in range(plan.grid[1]):
        for x in range(tx):
            g = gy * tx + x
            if g >= groups:
                continue
            ch = np.arange(g * cep.EPI_GROUP, min(g * cep.EPI_GROUP + cep.EPI_GROUP, c))
            for gx in range(plan.grid[0]):
                for y in range(ty):
                    p = np.arange(gx * ty + y, P, plan.grid[0] * ty)
                    hits[np.ix_(p, ch)] += 1
    return hits


@pytest.mark.parametrize("b,h,w,c,sms", [(2, 3, 5, 20, 132), (3, 17, 9, 300, 2),
                                         (1, 2, 2, 4200, 1), (5, 11, 13, 40, 1)])
@pytest.mark.parametrize("layout", ["rows", "nchw"])
def test_launch_grid_covers_every_output_once(b, h, w, c, sms, layout):
    if layout == "nchw":
        strides = (c * h * w, w, 1, h * w)
    else:
        strides = (h * w * c, w * c, c, 1)
    plan = cep.conv_epilogue_plan(b, h, w, c, strides, sms=sms)
    assert plan.variant == ("rows_vec" if layout == "rows" and c % 4 == 0 else "rows")
    assert (_covered(plan, b, h, w, c) == 1).all()


def _net_case(graph_fn):
    g = graph_fn()
    cfg = QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                      correction=True, bits_bias=16)
    prep = prepare(g, init_params(g, seed=0, bn_stats="random"), cfg)
    model = lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model.layers}
    rng = np.random.default_rng(5)
    x = torch.from_numpy(np.clip(rng.normal(0, 1, (2, 32, 32, 3)), -2.117, 2.64)
                         .astype(np.float32))
    return model, residual, x


@pytest.mark.parametrize("graph_fn,n_conv", [(mobilenet_v2, 1), (resnet18, 20)],
                         ids=["mobilenet_v2", "resnet18"])
def test_fused_net_keeps_the_former_logits(graph_fn, n_conv, monkeypatch):
    model, residual, x = _net_case(graph_fn)
    got = {}
    for name, opts in (("cpu", {}), ("plain_kernels", dict(plain_kernels=True)),
                       ("use_kernels=False", dict(use_kernels=False))):
        cep.reset_counts()
        net = Int8FusedNet(model, device="cpu", params_f32=residual, **opts)
        if not opts:
            assert sum(k == "conv" for _, k, _ in net.lowering(2).steps) == n_conv
            # the glue conv sites, each with its route and packed epilogue
            sites = net.lowering(2).epilogue_sites
            assert [n for n, k, _ in net.lowering(2).steps if k == "conv"] == [
                n for n, _, _ in sites]
            assert all(isinstance(op, cep.ConvEpilogue) for _, _, op in sites)
        with torch.no_grad():
            got[name] = net(x)
        assert cep.EPILOGUE_LAUNCHES == 0
        # only the wrapper counts its plain runs, as the kernels' wrappers do
        assert cep.EPILOGUE_PLAIN_CALLS == (n_conv if name == "cpu" else 0)
    with monkeypatch.context() as m:
        m.setattr(cep, "conv_epilogue_packed", former_epilogue)
        m.setattr(cep, "conv_epilogue_plain", former_epilogue)
        with torch.no_grad():
            want = Int8FusedNet(model, device="cpu", params_f32=residual)(x)
    for name, out in got.items():
        assert torch.equal(out, want), name


def test_kernel_names_are_none_of_the_benchmarks_kernels():
    """``portbench/trace.py`` times the three kernels by these patterns;
    the epilogue's device functions are glue, so they match none."""
    src = (ROOT / "portbench" / "trace.py").read_text()
    block = src[src.index("KERNELS = {"):src.index("}", src.index("KERNELS = {"))]
    patterns = [re.compile(p) for p in re.findall(r're\.compile\(r"([^"]+)"\)', block)]
    assert len(patterns) == 3
    cu = (ROOT / "dfq_tpu_torch" / "csrc" / cep.SOURCE).read_text()
    names = re.findall(r"__global__ void __launch_bounds__\(\w+\) (\w+)\(", cu)
    assert names == ["conv_epilogue_rows_kernel"]
    assert not any(p.search(n) for p in patterns for n in names)
    assert set(ck.LAUNCHES) == set(ck.PLAIN_CALLS) == set(ck.VARIANTS) == {
        "matmul_int8_requant", "dw3x3_int8_requant", "fused_block_int8"}


def test_launch_arguments_match_the_cuda_source():
    """``_EpilogueArgs`` holds ``EpilogueArgs``' fields in its order, and
    the C entry point takes as many parameters as the wrapper declares:
    a mismatch shows only as a launch failure on the card."""
    cu = (ROOT / "dfq_tpu_torch" / "csrc" / cep.SOURCE).read_text()
    body = cu[cu.index("struct EpilogueArgs {"):cu.index("};", cu.index("struct EpilogueArgs {"))]
    decls = re.sub(r"//[^\n]*", "", body.split("{", 1)[1]).split(";")
    fields = [n for d in decls for n in re.findall(r"(\w+)\s*(?=,|$)", d.strip())]
    assert fields == [f for f, _ in cep._EpilogueArgs._fields_]
    sig = cu[cu.index('extern "C" int dfq_conv_epilogue('):]
    params = sig[sig.index("(") + 1:sig.index(")")].split(",")
    assert len(params) == len(cep._ARGTYPES) == 4
