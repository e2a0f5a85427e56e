"""The port's MobileNetV2 SSD-Lite vs the JAX package's, at full width
(300x300, 21 classes, 3000 priors) with random BN statistics.

- the builder's graph, the priors and ``quantized_priors`` are equal;
- ``prepare`` and ``lower_int8`` are bit-identical for the flagship
  config and for ``--relu --equalize`` (the CLI's defaults otherwise),
  with the detection flags (``delete_single``, ``is_detection``);
- ``Int8FusedNet(device="cpu")`` (the kernels' plain versions) matches
  ``jax.jit(execute_int8_fused(use_pallas=True, fuse_blocks=True))`` with
  the Pallas kernels in interpret mode, and ``Int8Net`` matches
  ``execute_int8``, at the JAX suite's engine tolerance
  (``tests/test_int8_fused.py:102``: ``rtol=0, atol=1e-4``);
- the f32 simulator: ``tests/test_torch_seg_det_sim.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfq_tpu.detection.box_utils import generate_ssd_priors as j_priors
from dfq_tpu.engine.int8 import execute_int8 as j_execute_int8
from dfq_tpu.engine.int8 import lower_int8 as j_lower_int8
from dfq_tpu.engine.int8_fused import execute_int8_fused
from dfq_tpu.models.common import init_params as j_init_params
from dfq_tpu.models.ssd import MB2_SSD_SPECS as J_SPECS
from dfq_tpu.models.ssd import SSDConfig as JSSDConfig
from dfq_tpu.models.ssd import mobilenet_v2_ssd_lite as j_ssd
from dfq_tpu.models.ssd import quantized_priors as j_quantized_priors
from dfq_tpu.pipeline import QuantConfig as JQuantConfig
from dfq_tpu.pipeline import prepare as j_prepare
from dfq_tpu_torch.detection.box_utils import generate_ssd_priors
from dfq_tpu_torch.engine import Int8FusedNet, Int8Net, lower_int8
from dfq_tpu_torch.interop import int8_model_from_jax, params_from_jax
from dfq_tpu_torch.models import init_params, mobilenet_v2_ssd_lite
from dfq_tpu_torch.models.ssd import MB2_SSD_SPECS, SSDConfig, quantized_priors
from dfq_tpu_torch.ops import cuda_int8 as ck
from dfq_tpu_torch.pipeline import QuantConfig, prepare
from test_torch_policies import port_counts, stride2_dw_sites

torch.set_num_threads(1)

DET = dict(delete_single=True, is_detection=True)
CONFIGS = {
    "flagship": dict(quantize=True, relu=True, equalize=True, absorption=True,
                     correction=True, bits_bias=16, **DET),
    "relu_equalize": dict(quantize=True, relu=True, equalize=True, **DET),
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


def test_graph_equal():
    assert _nodes(mobilenet_v2_ssd_lite()) == _nodes(j_ssd())
    assert _nodes(mobilenet_v2_ssd_lite(relu6=False, is_test=False)) == _nodes(
        j_ssd(relu6=False, is_test=False))


def test_priors_equal():
    assert [dataclasses.astuple(s) for s in MB2_SSD_SPECS] == [dataclasses.astuple(s) for s in J_SPECS]
    p = SSDConfig().priors
    assert p.shape == (3000, 4) and p.dtype == np.float32
    assert np.array_equal(p, JSSDConfig().priors)
    assert np.array_equal(generate_ssd_priors(MB2_SSD_SPECS, 300, clamp=False),
                          j_priors(J_SPECS, 300, clamp=False))
    for bits in (8, 6):
        q = quantized_priors(SSDConfig(), bits=bits)
        assert q.dtype == np.float32
        assert np.array_equal(q, j_quantized_priors(JSSDConfig(), bits=bits))


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def both(request):
    kw = CONFIGS[request.param]
    g = j_ssd()
    pj = j_prepare(g, j_init_params(g, seed=0, bn_stats="random"), JQuantConfig(**kw))
    gt = mobilenet_v2_ssd_lite()
    pt = prepare(gt, init_params(gt, seed=0, bn_stats="random"), QuantConfig(**kw))
    return pj, pt


def test_prepare_and_lower_equal(both):
    pj, pt = both
    assert _nodes(pj.graph) == _nodes(pt.graph)
    _params_equal(pj.params, pt.params)
    _params_equal(pj.params_fp, pt.params_fp)
    assert pj.act_ranges.keys() == pt.act_ranges.keys()
    for site in pj.act_ranges:
        assert tuple(pj.act_ranges[site]) == tuple(pt.act_ranges[site]), site
    mj, mt = j_lower_int8(pj), lower_int8(pt)
    _models_equal(mj, mt)
    # every conv of the graph lowers (tests/test_int8_seg_det.py:139-163)
    assert sorted(mt.layers) == sorted(n.name for n in pt.graph if n.op == "conv")
    assert len(mt.layers) == 86


@pytest.fixture(scope="module")
def engines():
    """The flagship SSD-Lite lowered by the JAX package, its two engines'
    outputs at 300x300 batch 1, and the same model carried across."""
    kw = CONFIGS["flagship"]
    g = j_ssd()
    prep = j_prepare(g, j_init_params(g, seed=0, bn_stats="random"), JQuantConfig(**kw))
    model = j_lower_int8(prep)
    rng = np.random.default_rng(1)
    x = np.clip(rng.normal(0, 0.5, (1, 300, 300, 3)), -1, 1).astype(np.float32)
    fused = jax.jit(lambda v: execute_int8_fused(
        model, prep.params, v, use_pallas=True, fuse_blocks=True))(jnp.asarray(x))
    base = jax.jit(lambda v: j_execute_int8(model, prep.params, v))(jnp.asarray(x))
    tmodel = int8_model_from_jax(model)
    residual = params_from_jax({k: v for k, v in prep.params.items() if k not in model.layers})
    return tmodel, residual, x, [np.asarray(t) for t in fused], [np.asarray(t) for t in base]


def _close(got, want):
    for g, w, shape in zip(got, want, ((1, 3000, 21), (1, 3000, 4))):
        g = g.numpy()
        assert g.shape == w.shape == shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_fused_engine_matches_jax(engines):
    model, residual, x, want, _ = engines
    net = Int8FusedNet(model, device="cpu", params_f32=residual)
    ck.reset_counts()
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    _close(got, want)
    np.testing.assert_allclose(got[0].numpy().sum(-1), 1.0, atol=1e-4)
    # K1 at the 24 pointwise convs and the 6 class heads (N = 126); K2 at
    # base_net.1 and the 10 separable heads; K3 at 12 blocks (JAX's
    # pallas_call sites); K2 at the 8 stride-2 depthwise convs; all of them
    # the plain versions on the CPU
    assert stride2_dw_sites(model) == 8
    assert ck.PLAIN_CALLS == port_counts({"matmul_int8_requant": 30, "dw3x3_int8_requant": 11,
                                          "fused_block_int8": 12}, model)
    assert ck.LAUNCHES == dict.fromkeys(ck.LAUNCHES, 0)
    # of the 9 lowered convs that JAX leaves to XLA (the stem, the 8
    # stride-2 depthwise convs), the stem is the one exact int8 product
    assert len(net.products) == 9 - stride2_dw_sites(model)


def test_baseline_engine_matches_jax(engines):
    model, residual, x, _, want = engines
    with torch.no_grad():
        got = Int8Net(model, residual, device="cpu")(torch.from_numpy(x))
    _close(got, want)
