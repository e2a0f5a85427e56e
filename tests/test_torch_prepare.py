"""The port's DFQ pipeline and int8 lowering vs the JAX package's, on
full-width MobileNetV2 with random BN statistics and the flagship config
(``__graft_entry__.py:18-22``). Both sides are host numpy, so every
post-pass param, every activation range and every lowered field must be
equal, not close."""

import numpy as np
import pytest
import torch

from dfq_tpu.engine.int8 import lower_int8 as j_lower_int8
from dfq_tpu.engine.int8_fused import _consumer_plan as j_plan
from dfq_tpu.engine.int8_fused import _find_fusable_blocks as j_blocks
from dfq_tpu.models.common import init_params as j_init_params
from dfq_tpu.models.mobilenet_v2 import mobilenet_v2 as j_mobilenet_v2
from dfq_tpu.pipeline import QuantConfig as JQuantConfig
from dfq_tpu.pipeline import prepare as j_prepare
from dfq_tpu_torch.engine.int8 import lower_int8
from dfq_tpu_torch.engine.int8_fused import _consumer_plan, _find_fusable_blocks
from dfq_tpu_torch.models import init_params, mobilenet_v2
from dfq_tpu_torch.pipeline import QuantConfig, prepare

torch.set_num_threads(1)

FLAGSHIP = dict(quantize=True, relu=True, equalize=True, absorption=True,
                correction=True, bits_bias=16)
CONFIGS = {
    "flagship": FLAGSHIP,
    "equalize_only": dict(quantize=True, relu=True, equalize=True, bits_bias=16),
    "clip_signed": dict(quantize=True, relu=True, equalize=True, clip_weight=True,
                        signed=True, bits_bias=8),
}


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def both(request):
    kw = CONFIGS[request.param]
    pj = j_prepare(j_mobilenet_v2(), j_init_params(j_mobilenet_v2(), seed=0,
                                                   bn_stats="random"), JQuantConfig(**kw))
    pt = prepare(mobilenet_v2(), init_params(mobilenet_v2(), seed=0, bn_stats="random"),
                 QuantConfig(**kw))
    return pj, pt


def _params_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].keys() == b[k].keys(), k
        for n in a[k]:
            x, y = np.asarray(a[k][n]), np.asarray(b[k][n])
            assert x.dtype == y.dtype and np.array_equal(x, y), (k, n)


def test_prepare_equal(both):
    pj, pt = both
    assert [(n.name, n.op, n.inputs, n.attrs) for n in pj.graph] == [
        (n.name, n.op, n.inputs, n.attrs) for n in pt.graph]
    _params_equal(pj.params, pt.params)
    _params_equal(pj.params_fp, pt.params_fp)
    assert pj.act_ranges.keys() == pt.act_ranges.keys()
    for site in pj.act_ranges:
        assert tuple(pj.act_ranges[site]) == tuple(pt.act_ranges[site]), site


def test_lower_int8_equal(both):
    pj, pt = both
    mj, mt = j_lower_int8(pj), lower_int8(pt)
    assert mj.bits_act == mt.bits_act and mj.layers.keys() == mt.layers.keys()
    for name, lj in mj.layers.items():
        lt = mt.layers[name]
        for f in ("qweight", "w_scale", "wsum"):
            x, y = getattr(lj, f), getattr(lt, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (name, f)
        assert (lj.bias is None) == (lt.bias is None)
        if lj.bias is not None:
            assert lj.bias.dtype == lt.bias.dtype and np.array_equal(lj.bias, lt.bias)
        assert (lj.in_scale, lj.in_zp) == (lt.in_scale, lt.in_zp), name
    # the fused engine's consumer plan and block set
    assert j_plan(mj.graph, mj) == _consumer_plan(mt.graph, mt)
    bj, bt = j_blocks(mj.graph, mj, j_plan(mj.graph, mj)), _find_fusable_blocks(
        mt.graph, mt, _consumer_plan(mt.graph, mt))
    assert bj == bt
    assert len(bt) == 12
    assert sum(b["res"] is not None for b in bt.values()) == 10


def test_quant_config_invariants():
    with pytest.raises(ValueError, match="ReLU6->ReLU"):
        QuantConfig(equalize=True)
    with pytest.raises(ValueError, match="absorption requires"):
        QuantConfig(relu=True, absorption=True)
    with pytest.raises(ValueError, match="exclusive"):
        QuantConfig(trainable=True, distill_range=True)


def test_lower_int8_rejects_wide_regimes():
    pt = prepare(mobilenet_v2(), init_params(mobilenet_v2(), seed=0),
                 QuantConfig(quantize=True, relu=True, bits_weight=16))
    with pytest.raises(ValueError, match="bits_weight <= 8"):
        lower_int8(pt)


def test_prepare_from_params_carried_across():
    """``interop`` carries the JAX package's graph and params across; the
    port's pipeline on them equals the JAX pipeline."""
    from dfq_tpu_torch.interop import graph_from_jax, params_from_jax

    gj = j_mobilenet_v2()
    pj_in = j_init_params(gj, seed=7, bn_stats="random")
    pj = j_prepare(gj, pj_in, JQuantConfig(**FLAGSHIP))
    pt = prepare(graph_from_jax(gj), params_from_jax(pj_in), QuantConfig(**FLAGSHIP))
    _params_equal(pj.params, pt.params)
    assert pj.act_ranges == pt.act_ranges


def test_quantize_act_matches_jitted_jax():
    import jax
    import jax.numpy as jnp

    from dfq_tpu.engine.int8 import _quantize_act as j_quantize_act
    from dfq_tpu_torch.engine.int8 import Int8Layer, _quantize_act

    x = np.random.default_rng(0).normal(0, 2, (8, 33, 33, 3)).astype(np.float32)
    for in_scale, in_zp, qmax in ((0.0187, -11, 255.0), (0.0433, 3, 63.0)):
        layer = Int8Layer(np.zeros((1, 3, 1, 1), np.int8), np.ones(1, np.float32), None,
                          np.zeros(1, np.int32), in_scale, in_zp)
        want = np.asarray(jax.jit(lambda v: j_quantize_act(v, layer, qmax))(jnp.asarray(x)))
        got = _quantize_act(torch.from_numpy(x), layer, qmax).numpy()
        np.testing.assert_array_equal(got, want)
