"""The port's DeepLab-v3+ MobileNetV2 (output stride 16, 21 classes) vs
the JAX package's, with random BN statistics.

- the builder's graph is equal at 129x129 and at the CLI's 513x513;
- ``prepare`` and ``lower_int8`` are bit-identical at 129x129 for the
  flagship config and for ``--relu --equalize``;
- ``Int8FusedNet(device="cpu")`` matches ``jax.jit(execute_int8_fused(
  use_pallas=True, fuse_blocks=True))`` (Pallas in interpret mode) and
  ``Int8Net`` matches ``execute_int8`` at 129x129 batch 1, at the JAX
  suite's engine tolerance (``rtol=0, atol=1e-4``), with the argmax equal
  on at least 99.9% of the pixels; and at 257x257, where the resizes run
  17 -> 65 -> 257, with the argmax equal everywhere (both need the
  bilinear resize's taps summed in XLA:CPU's form for each length). K1 runs at all 38
  pointwise convs; K2 and K3 never, in either package: the backbone pads
  each block's input explicitly and runs its depthwise convs unpadded
  (``dfq_tpu/models/deeplab.py:142-158``), which neither kernel takes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfq_tpu.engine.int8 import execute_int8 as j_execute_int8
from dfq_tpu.engine.int8 import lower_int8 as j_lower_int8
from dfq_tpu.engine.int8_fused import execute_int8_fused
from dfq_tpu.models.common import init_params as j_init_params
from dfq_tpu.models.deeplab import deeplab_mobilenet_v2 as j_deeplab
from dfq_tpu.pipeline import QuantConfig as JQuantConfig
from dfq_tpu.pipeline import prepare as j_prepare
from dfq_tpu_torch.engine import Int8FusedNet, Int8Net, lower_int8
from dfq_tpu_torch.interop import int8_model_from_jax, params_from_jax
from dfq_tpu_torch.models import deeplab_mobilenet_v2, init_params
from dfq_tpu_torch.ops import cuda_int8 as ck
from dfq_tpu_torch.pipeline import QuantConfig, prepare
from test_torch_policies import port_counts, stride2_dw_sites

torch.set_num_threads(1)

CONFIGS = {
    "flagship": dict(quantize=True, relu=True, equalize=True, absorption=True,
                     correction=True, bits_bias=16),
    "relu_equalize": dict(quantize=True, relu=True, equalize=True),
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


@pytest.mark.parametrize("size", [129, 513])
def test_graph_equal(size):
    assert _nodes(deeplab_mobilenet_v2(input_size=size)) == _nodes(j_deeplab(input_size=size))
    assert _nodes(deeplab_mobilenet_v2(input_size=size, relu6=False, output_stride=8)) == \
        _nodes(j_deeplab(input_size=size, relu6=False, output_stride=8))


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_prepare_and_lower_equal(config):
    kw = CONFIGS[config]
    g = j_deeplab(input_size=129)
    pj = j_prepare(g, j_init_params(g, seed=0, bn_stats="random"), JQuantConfig(**kw))
    gt = deeplab_mobilenet_v2(input_size=129)
    pt = prepare(gt, init_params(gt, seed=0, bn_stats="random"), QuantConfig(**kw))
    assert _nodes(pj.graph) == _nodes(pt.graph)
    _params_equal(pj.params, pt.params)
    _params_equal(pj.params_fp, pt.params_fp)
    assert {k: tuple(v) for k, v in pj.act_ranges.items()} == {
        k: tuple(v) for k, v in pt.act_ranges.items()}
    mj, mt = j_lower_int8(pj), lower_int8(pt)
    assert mj.layers.keys() == mt.layers.keys() and len(mt.layers) == 61
    assert mj.act_ranges == mt.act_ranges
    for name, lj in mj.layers.items():
        lt = mt.layers[name]
        for f in ("qweight", "w_scale", "wsum", "bias"):
            x, y = getattr(lj, f), getattr(lt, f)
            assert (x is None) == (y is None), (name, f)
            assert x is None or (x.dtype == y.dtype and np.array_equal(x, y)), (name, f)
        assert (lj.in_scale, lj.in_zp) == (lt.in_scale, lt.in_zp), name


@pytest.fixture(scope="module")
def engines():
    kw = CONFIGS["flagship"]
    g = j_deeplab(input_size=129)
    prep = j_prepare(g, j_init_params(g, seed=0, bn_stats="random"), JQuantConfig(**kw))
    model = j_lower_int8(prep)
    rng = np.random.default_rng(0)
    x = np.clip(rng.normal(0, 1, (1, 129, 129, 3)), -2.117, 2.64).astype(np.float32)
    fused = jax.jit(lambda v: execute_int8_fused(
        model, prep.params, v, use_pallas=True, fuse_blocks=True))(jnp.asarray(x))
    base = jax.jit(lambda v: j_execute_int8(model, prep.params, v))(jnp.asarray(x))
    residual = params_from_jax({k: v for k, v in prep.params.items() if k not in model.layers})
    return int8_model_from_jax(model), residual, x, np.asarray(fused), np.asarray(base)


def _close(got, want):
    got = got.numpy()
    assert got.shape == want.shape == (1, 129, 129, 21) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.999


def test_fused_engine_matches_jax(engines):
    model, residual, x, want, _ = engines
    net = Int8FusedNet(model, device="cpu", params_f32=residual)
    ck.reset_counts()
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    _close(got, want)
    # JAX's pallas_call sites; the depthwise convs are padded explicitly
    # and run unpadded, so none is a stride-2 K2 site
    assert stride2_dw_sites(model) == 0
    assert ck.PLAIN_CALLS == port_counts({"matmul_int8_requant": 38, "dw3x3_int8_requant": 0,
                                          "fused_block_int8": 0}, model)
    assert not net.blocks
    # the stem, 17 depthwise convs, 3 dilated ASPP convs, 2 decoder convs
    assert len(net.products) == 23


def test_baseline_engine_matches_jax(engines):
    model, residual, x, _, want = engines
    with torch.no_grad():
        got = Int8Net(model, residual, device="cpu")(torch.from_numpy(x))
    _close(got, want)


@pytest.mark.parametrize("engine", ["fused", "baseline"])
def test_engines_match_jax_at_257(engine):
    """At 257x257 the decoder resizes 17 -> 65 and the output 65 -> 257,
    lengths where XLA:CPU sums the two taps as two rounded products and an
    add (``RESIZE_FMA_LENGTHS`` in the port's executor); the port mirrors
    that form, so both engines agree with JAX to the JAX suite's limit."""
    g = j_deeplab(input_size=257)
    prep = j_prepare(g, j_init_params(g, seed=0, bn_stats="random"),
                     JQuantConfig(**CONFIGS["flagship"]))
    model = j_lower_int8(prep)
    x = np.clip(np.random.default_rng(0).normal(0, 1, (1, 257, 257, 3)), -2.117,
                2.64).astype(np.float32)
    residual = params_from_jax({k: v for k, v in prep.params.items() if k not in model.layers})
    tmodel = int8_model_from_jax(model)
    if engine == "fused":
        want = jax.jit(lambda v: execute_int8_fused(
            model, prep.params, v, use_pallas=True, fuse_blocks=True))(jnp.asarray(x))
        net = Int8FusedNet(tmodel, device="cpu", params_f32=residual)
    else:
        want = jax.jit(lambda v: j_execute_int8(model, prep.params, v))(jnp.asarray(x))
        net = Int8Net(tmodel, residual, device="cpu")
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    want = np.asarray(want)
    assert got.shape == want.shape == (1, 257, 257, 21) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
