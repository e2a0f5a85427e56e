"""The rest of the model zoo on the port against the JAX package: AlexNet,
the DeepLab-v3+ Xception, DRN-D-54 and ResNet-101 backbones, and the
SSD variants (MobileNetV1-SSD, -SSD-Lite, SqueezeNet-SSD-Lite,
FPN-MobileNetV1-SSD, VGG16-SSD), with random weights.

- every builder's graph equals JAX's node for node (DeepLab also at output
  stride 8 and at 65x65), and the VGG and SqueezeNet priors are equal;
- the fused engine's kernel sites against the JAX routing:
  ``tests/test_torch_zoo_routing.py`` (with ``_pallas_counts`` and
  ``JAX_SITES`` from here);
- ``prepare`` and ``lower_int8`` are bit-identical for AlexNet
  (``--relu --equalize`` with ``distill_range``, then JAX's
  ``calibrate_ranges`` on one seeded batch carried across), and its two
  engines on the CPU, ``Int8FusedNet(device="cpu")`` (the kernels' plain
  versions) and ``Int8Net``, match JAX's fused engine (Pallas in
  interpret mode) and ``execute_int8`` at 224x224 at the JAX suite's
  ``atol=1e-4``; DRN-D-54 and MobileNetV1-SSD-Lite are held the same way
  in ``tests/test_torch_zoo_engines.py``. The ops only VGG16-SSD, FPN-MobileNetV1-SSD and
  SqueezeNet-SSD-Lite have, whose whole 300x300 graphs do not fit the
  test budget, are held in ``_variant_ops``, a ``GraphBuilder`` subgraph:
  the ceil-mode pool as an explicit ``pad``, the 3x3 stride-1 max pool,
  the dilation-6 conv, the BatchNorm add-on on a tap, a Fire module's
  concat, valid 3x3 extras, and the FPN's bilinear upsample and add at
  its 5 -> 10 -> 19 lengths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dfq_tpu.models as jm
from dfq_tpu.calib import calibrate_ranges as j_calibrate_ranges
from dfq_tpu.engine.int8 import execute_int8 as j_execute_int8
from dfq_tpu.engine.int8 import lower_int8 as j_lower_int8
from dfq_tpu.engine.int8_fused import execute_int8_fused
from dfq_tpu.graph.ir import GraphBuilder as JGraphBuilder
from dfq_tpu.models.common import init_params as j_init_params
from dfq_tpu.pipeline import QuantConfig as JQuantConfig
from dfq_tpu.pipeline import prepare as j_prepare
import dfq_tpu_torch.models as tm
from dfq_tpu_torch.engine import Int8FusedNet, Int8Net, lower_int8
from dfq_tpu_torch.interop import graph_from_jax, int8_model_from_jax, params_from_jax
from dfq_tpu_torch.models import init_params
from dfq_tpu_torch.pipeline import QuantConfig, prepare

torch.set_num_threads(1)

DET = dict(delete_single=True, is_detection=True)
KERNELS = ("matmul_int8_requant", "dw3x3_int8_requant", "fused_block_int8")
# builder, input size, detection model
MODELS = {
    "alexnet": (lambda m: m.alexnet(), 224, False),
    "deeplab_xception": (lambda m: m.deeplab_xception(input_size=65), 65, False),
    "deeplab_drn": (lambda m: m.deeplab_drn(input_size=65), 65, False),
    "deeplab_resnet101": (lambda m: m.deeplab_resnet101(input_size=65), 65, False),
    "mobilenet_v1_ssd": (lambda m: m.mobilenet_v1_ssd(), 300, True),
    "mobilenet_v1_ssd_lite": (lambda m: m.mobilenet_v1_ssd_lite(), 300, True),
    "squeezenet_ssd_lite": (lambda m: m.squeezenet_ssd_lite(), 300, True),
    "fpn_mobilenet_v1_ssd": (lambda m: m.fpn_mobilenet_v1_ssd(), 300, True),
    "vgg16_ssd": (lambda m: m.vgg16_ssd(), 300, True),
}
# the JAX fused engine's pallas_call counts per forward, as the
# make_jaxpr count below reads them (pinned so a routing change in either
# package shows here and in chip_smoke.py's phase 17)
JAX_SITES = {
    "alexnet": (3, 0, 0),
    "deeplab_xception": (69, 0, 0),
    "deeplab_drn": (39, 0, 0),
    "deeplab_resnet101": (73, 0, 0),
    "mobilenet_v1_ssd": (5, 3, 6),
    "mobilenet_v1_ssd_lite": (21, 13, 6),
    "squeezenet_ssd_lite": (38, 10, 0),
    "fpn_mobilenet_v1_ssd": (7, 3, 6),
    "vgg16_ssd": (5, 0, 0),
}


def _nodes(g):
    return [(n.name, n.op, tuple(n.inputs), n.attrs) for n in g], list(g.outputs)


def _params_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].keys() == b[k].keys(), k
        for n in a[k]:
            x, y = np.asarray(a[k][n]), np.asarray(b[k][n])
            assert x.dtype == y.dtype and np.array_equal(x, y), (k, n)


def _models_equal(mj, mt):
    assert mj.bits_act == mt.bits_act and mj.layers.keys() == mt.layers.keys()
    assert mj.act_ranges == mt.act_ranges
    for name, lj in mj.layers.items():
        lt = mt.layers[name]
        for f in ("qweight", "w_scale", "wsum"):
            x, y = getattr(lj, f), getattr(lt, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (name, f)
        assert (lj.bias is None) == (lt.bias is None)
        if lj.bias is not None:
            assert np.array_equal(lj.bias, lt.bias), name
        assert (lj.in_scale, lj.in_zp) == (lt.in_scale, lt.in_zp), name


def _pallas_counts(model, params, size):
    """The pallas_call equations of one traced JAX fused forward, by
    kernel: K1's output is 2-D, K3 takes more than six operands."""
    jaxpr = jax.make_jaxpr(lambda v: execute_int8_fused(
        model, params, v, use_pallas=True, fuse_blocks=True))(jnp.zeros((1, size, size, 3)))
    counts = dict.fromkeys(KERNELS, 0)

    def walk(j):
        for e in j.eqns:
            if e.primitive.name == "pallas_call":
                if len(e.params["out_avals"][0].shape) == 2:
                    counts["matmul_int8_requant"] += 1
                elif len(e.invars) > 6:
                    counts["fused_block_int8"] += 1
                else:
                    counts["dw3x3_int8_requant"] += 1
                continue
            for v in e.params.values():
                if hasattr(v, "eqns"):
                    walk(v)
                elif hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
                    walk(v.jaxpr)

    walk(jaxpr.jaxpr)
    return counts


@pytest.mark.parametrize("name", sorted(MODELS))
def test_graph_equal(name):
    build = MODELS[name][0]
    assert _nodes(build(tm)) == _nodes(build(jm))


def test_deeplab_variants_graph_equal():
    assert _nodes(tm.deeplab_xception(output_stride=8, input_size=65)) == _nodes(
        jm.deeplab_xception(output_stride=8, input_size=65))
    assert _nodes(tm.deeplab_resnet101(output_stride=8, input_size=65)) == _nodes(
        jm.deeplab_resnet101(output_stride=8, input_size=65))
    for fn in ("deeplab_xception", "deeplab_drn", "deeplab_resnet101"):
        assert _nodes(getattr(tm, fn)()) == _nodes(getattr(jm, fn)())


@pytest.mark.parametrize("config", ["vgg_ssd_config", "squeezenet_ssd_config"])
def test_priors_equal(config):
    pt, pj = getattr(tm, config)(), getattr(jm, config)()
    assert dataclasses.astuple(pt)[:2] == dataclasses.astuple(pj)[:2]
    assert pt.priors.dtype == np.float32 and np.array_equal(pt.priors, pj.priors)
    assert pt.priors.shape == {"vgg_ssd_config": (8732, 4),
                               "squeezenet_ssd_config": (2568, 4)}[config]


def _both(build, cfg, ranges_batch=None, seed=0):
    """The same model prepared by both packages; with ``ranges_batch``
    (BN-less models) JAX's calibrated ranges on it, given to both."""
    g = build(jm)
    pj = j_prepare(g, j_init_params(g, seed=seed, bn_stats="random"), JQuantConfig(**cfg))
    gt = build(tm)
    pt = prepare(gt, init_params(gt, seed=seed, bn_stats="random"), QuantConfig(**cfg))
    if ranges_batch is not None:
        pj.act_ranges = j_calibrate_ranges(pj.graph, pj.params, [ranges_batch],
                                           is_detection=cfg.get("is_detection", False))
        pt.act_ranges = {k: (float(lo), float(hi)) for k, (lo, hi) in pj.act_ranges.items()}
    return pj, pt


def _check_prepared(pj, pt):
    assert _nodes(pj.graph) == _nodes(pt.graph)
    _params_equal(pj.params, pt.params)
    _params_equal(pj.params_fp, pt.params_fp)
    assert {k: tuple(v) for k, v in pj.act_ranges.items()} == pt.act_ranges
    mj, mt = j_lower_int8(pj), lower_int8(pt)
    _models_equal(mj, mt)
    return mj, mt


def _check_engines(pj, mj, x):
    """Both engines of the port on the CPU against JAX's, atol 1e-4."""
    tmodel = int8_model_from_jax(mj)
    residual = params_from_jax({k: v for k, v in pj.params.items() if k not in mj.layers})
    want_f = jax.jit(lambda v: execute_int8_fused(
        mj, pj.params, v, use_pallas=True, fuse_blocks=True))(jnp.asarray(x))
    want_b = jax.jit(lambda v: j_execute_int8(mj, pj.params, v))(jnp.asarray(x))
    with torch.no_grad():
        got_f = Int8FusedNet(tmodel, device="cpu", params_f32=residual)(torch.from_numpy(x))
        got_b = Int8Net(tmodel, residual, device="cpu")(torch.from_numpy(x))
    for got, want in ((got_f, want_f), (got_b, want_b)):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert len(got) == len(want)
        for g_, w_ in zip(got, want):
            g_, w_ = g_.numpy(), np.asarray(w_)
            assert g_.shape == w_.shape and np.isfinite(g_).all()
            np.testing.assert_allclose(g_, w_, rtol=0, atol=1e-4)


def test_alexnet_prepare_lower_and_engines():
    cfg = dict(quantize=True, relu=True, equalize=True, bits_bias=16, distill_range=True)
    rng = np.random.default_rng(2)
    batch = np.clip(rng.normal(0, 1, (2, 224, 224, 3)), -2.117, 2.64).astype(np.float32)
    pj, pt = _both(MODELS["alexnet"][0], cfg, ranges_batch=batch)
    mj, _ = _check_prepared(pj, pt)
    _check_engines(pj, mj, batch[:1])


def _variant_ops(b):
    """What VGG16-SSD, FPN-MobileNetV1-SSD and SqueezeNet-SSD-Lite build
    that the tests above do not run, on a 40x40 input: two heads, as the
    SSD graphs' outputs."""
    x = b.input("data")
    x = b.conv("c0", x, 3, 16, (3, 3), padding=(1, 1), bias=True)
    x = b.relu("r0", x)
    # VGG's ceil-mode pool (ssd_variants.py:294) on an odd map: 39 -> 20
    x = b.conv("c1", x, 16, 16, (3, 3), padding=(0, 0), bias=True)  # 38
    x = b.relu("r1", x)
    x = b.maxpool("p1", x, window=(2, 2), stride=(2, 2))  # 19
    tap = b.bn("addon", x, 16)  # the BatchNorm add-on on the conv4_3 tap
    x = b.pad("p2.pad", x, pads=(0, 1, 0, 1))
    x = b.maxpool("p2", x, window=(2, 2), stride=(2, 2))  # 10
    # pool5 (3x3, stride 1, pad 1) and the dilation-6 conv6
    y = b.maxpool("p3", x, window=(3, 3), stride=(1, 1), padding=(1, 1))
    y = b.conv("c6", y, 16, 32, (3, 3), padding=(6, 6), dilation=(6, 6), bias=True)
    y = b.relu("r6", y)
    # a Fire module: squeeze, then expand 1x1 and 3x3 concatenated
    s = b.conv("f.squeeze", y, 32, 8, (1, 1), bias=True)
    s = b.relu("f.squeeze_activation", s)
    e1 = b.relu("f.e1a", b.conv("f.expand1x1", s, 8, 16, (1, 1), bias=True))
    e3 = b.relu("f.e3a", b.conv("f.expand3x3", s, 8, 16, (3, 3), padding=(1, 1), bias=True))
    y = b.concat("f.cat", [e1, e3], axis=-1)  # 10x10x32
    # a valid 3x3 extra (VGG's last two) and the FPN's top-down path
    z = b.conv("e.0", y, 32, 16, (1, 1), bias=True)
    z = b.relu("e.1", z)
    z = b.conv("e.2", z, 16, 16, (3, 3), stride=(2, 2), padding=(1, 1), bias=True)  # 5
    z = b.relu("e.3", z)
    v = b.conv("v.0", z, 16, 16, (3, 3), bias=True)  # 3
    v = b.relu("v.1", v)
    up = b.interpolate("fpn_up.1", z, size=(10, 10), mode="bilinear", align_corners=False)
    m = b.add("fpn_add.1", up, b.conv("lat", y, 32, 16, (1, 1), bias=True))
    up = b.interpolate("fpn_up.0", m, size=(19, 19), mode="bilinear", align_corners=False)
    m0 = b.add("fpn_add.0", up, b.conv("lat0", tap, 16, 16, (1, 1), bias=True))
    confs, locs = [], []
    for i, t in enumerate((m0, v)):
        confs.append(b.reshape(f"cr{i}", b.conv(f"ch{i}", t, 16, 4 * 21, (3, 3),
                                                padding=(1, 1), bias=True), shape=(-1, 21)))
        locs.append(b.reshape(f"lr{i}", b.conv(f"rh{i}", t, 16, 4 * 4, (3, 3),
                                               padding=(1, 1), bias=True), shape=(-1, 4)))
    conf = b.softmax("conf_softmax", b.concat("conf_cat", confs, axis=1), axis=2)
    return b.build([conf, b.concat("loc_cat", locs, axis=1)])


def test_ssd_variant_ops_engines():
    g = _variant_ops(JGraphBuilder())
    assert _nodes(graph_from_jax(g))[0][0][0] == "data"
    cfg = dict(quantize=True, relu=True, bits_bias=16, distill_range=True, **DET)
    rng = np.random.default_rng(4)
    batch = rng.uniform(-1, 1, (2, 40, 40, 3)).astype(np.float32)
    pj, pt = _both(lambda m: graph_from_jax(g) if m is tm else g, cfg, ranges_batch=batch)
    mj, _ = _check_prepared(pj, pt)
    _check_engines(pj, mj, batch)
