"""ResNet-18 through the port: the graph, ``prepare`` and ``lower_int8``
equal to the JAX package's field for field, and the fused engine
``Int8FusedNet(device="cpu")`` against ``jax.jit(execute_int8_fused(...,
use_pallas=True, fuse_blocks=True))`` (Pallas in interpret mode) at the
JAX suite's engine-vs-engine tolerance (``rtol=0, atol=1e-4``) with equal
argmax. Also the fused engine's ops that ResNet-18 and the other models
need beside the kernels (int8 max pooling, padding and concat, and each
op of the generic f32 fallback) on small graphs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfq_tpu.engine.int8 import lower_int8 as j_lower_int8
from dfq_tpu.engine.int8_fused import _consumer_plan as j_plan
from dfq_tpu.engine.int8_fused import execute_int8_fused
from dfq_tpu.graph.executor import execute as j_execute
from dfq_tpu.graph.ir import GraphBuilder, quant_sites
from dfq_tpu.models.common import init_params as j_init_params
from dfq_tpu.models.resnet import resnet18 as j_resnet18
from dfq_tpu.pipeline import PreparedModel, QuantConfig, prepare
from dfq_tpu_torch.engine import Int8FusedNet
from dfq_tpu_torch.engine.int8 import lower_int8
from dfq_tpu_torch.engine.int8_fused import _consumer_plan
from dfq_tpu_torch.interop import int8_model_from_jax, params_from_jax
from dfq_tpu_torch.models import init_params, resnet18
from dfq_tpu_torch.ops import cuda_int8 as ck
from dfq_tpu_torch.pipeline import QuantConfig as TQuantConfig
from dfq_tpu_torch.pipeline import prepare as t_prepare
from test_torch_policies import port_counts

torch.set_num_threads(1)

FLAGSHIP = dict(quantize=True, relu=True, equalize=True, absorption=True,
                correction=True, bits_bias=16)


def test_resnet18_graph_equal():
    gj, gt = j_resnet18(), resnet18()
    assert [(n.name, n.op, tuple(n.inputs), n.attrs) for n in gj] == [
        (n.name, n.op, tuple(n.inputs), n.attrs) for n in gt]
    assert tuple(gj.outputs) == tuple(gt.outputs)
    convs = [n for n in gt if n.op == "conv"]
    assert len(convs) == 20 and sum(n.attrs["kernel"] == (3, 3) for n in convs) == 16


@pytest.fixture(scope="module")
def r18():
    g = j_resnet18()
    prep = prepare(g, j_init_params(g, seed=0, bn_stats="random"), QuantConfig(**FLAGSHIP))
    return prep, j_lower_int8(prep)


def test_prepare_and_lower_equal(r18):
    pj, mj = r18
    pt = t_prepare(resnet18(), init_params(resnet18(), seed=0, bn_stats="random"),
                   TQuantConfig(**FLAGSHIP))
    for a, b in ((pj.params, pt.params), (pj.params_fp, pt.params_fp)):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].keys() == b[k].keys()
            for n in a[k]:
                x, y = np.asarray(a[k][n]), np.asarray(b[k][n])
                assert x.dtype == y.dtype and np.array_equal(x, y), (k, n)
    assert pj.act_ranges == pt.act_ranges
    mt = lower_int8(pt)
    assert mj.layers.keys() == mt.layers.keys() and len(mt.layers) == 21
    for name, lj in mj.layers.items():
        lt = mt.layers[name]
        for f in ("qweight", "w_scale", "wsum", "bias"):
            x, y = getattr(lj, f), getattr(lt, f)
            assert x.dtype == y.dtype and np.array_equal(x, y), (name, f)
        assert (lj.in_scale, lj.in_zp) == (lt.in_scale, lt.in_zp), name
    assert j_plan(mj.graph, mj) == _consumer_plan(mt.graph, mt)


def test_fused_resnet18_matches_jax(r18):
    prep, model = r18
    rng = np.random.default_rng(1)
    x = np.clip(rng.normal(0, 1, (2, 64, 64, 3)), -2.117, 2.64).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: execute_int8_fused(
        model, prep.params, v, use_pallas=True, fuse_blocks=True))(jnp.asarray(x)))
    tmodel = int8_model_from_jax(model)
    net = Int8FusedNet(tmodel, device="cpu", params_f32=params_from_jax(prep.params))
    ck.reset_counts()
    with torch.no_grad():
        got = net(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1000) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    # the fc is the one kernel site: K1, to its plain version on the CPU
    # (JAX's pallas_call sites; no depthwise conv)
    assert ck.PLAIN_CALLS == port_counts({"matmul_int8_requant": 1, "dw3x3_int8_requant": 0,
                                          "fused_block_int8": 0}, tmodel)
    assert ck.LAUNCHES == dict.fromkeys(ck.LAUNCHES, 0)
    assert [(n, k) for n, k, _ in net.kernel_sites] == [("fc", "matmul_int8_requant")]


# -- the fused engine's other ops, on small graphs ---------------------------

def _int8_ops_graph():
    """int8 max pooling, int8 padding and an int8 concat."""
    b = GraphBuilder()
    x = b.input("data")
    x = b.conv("c1", x, 3, 8, (3, 3), padding=(1, 1))
    x = b.bn("b1", x, 8)
    r = b.relu("r1", x)
    mp = b.maxpool("mp", r, window=(3, 3), stride=(2, 2), padding=(1, 1))
    pd = b.pad("pd", mp, pads=(1, 1, 1, 1))
    c2 = b.conv("c2", pd, 8, 8, (3, 3))
    c3 = b.conv("c3", mp, 8, 8, (1, 1))
    cat = b.concat("cat", [c2, c3])
    x = b.conv("c4", cat, 16, 16, (1, 1))
    x = b.relu("r4", x)
    x = b.global_mean("gm", x)
    x = b.linear("fc", x, 16, 10)
    return b.build([x]), set()


def _fallback_graph():
    """Every op of the generic f32 fallback: a conv and a linear left
    unlowered, avgpool, f32 pad, bilinear and nearest resize, softmax,
    l2norm, f32 concat, global_pool, reshape, permute_nchw."""
    b = GraphBuilder()
    x = b.input("data")
    x = b.conv("c1", x, 3, 8, (3, 3), padding=(1, 1))
    x = b.relu("r1", x)
    x = b.avgpool("ap", x, window=(2, 2), padding=(1, 1))
    x = b.conv("c2", x, 8, 8, (1, 1), bias=True)
    x = b.pad("pd", x, pads=(1, 0, 0, 1))
    it = b.interpolate("it", x, size=(20, 20), align_corners=False)
    nr = b.interpolate("nr", x, scale=2.0, mode="nearest")
    sm = b.softmax("sm", it)
    l2 = b.l2norm("l2", sm, 8)
    cat = b.concat("cat", [l2, nr])
    gp = b.global_pool("gp", cat)
    rs = b.reshape("rs", gp, shape=(16,))
    fc = b.linear("fc", rs, 16, 10)
    pm = b.permute_nchw("pm", cat, perm=(0, 2, 3, 1))
    return b.build([fc, pm]), {"c2", "fc"}


def _small_model(graph, unlowered):
    """Fold, random BN stats, ranges for every site from the simulator's
    ``minmax`` capture on random data, then ``lower_int8``; the layers in
    ``unlowered`` are dropped from the lowering (``c2`` also loses its
    site range, ``fc`` keeps it)."""
    params = j_init_params(graph, seed=3, bn_stats="random")
    for name in unlowered:
        if "bias" in params[name]:
            params[name]["bias"] = np.random.default_rng(4).normal(
                0, 0.1, params[name]["bias"].shape).astype(np.float32)
    prep = prepare(graph, params, QuantConfig(quantize=False, bits_bias=16))
    rng = np.random.default_rng(5)
    x = np.clip(rng.normal(0, 1, (4, 16, 16, 3)), -2.117, 2.64).astype(np.float32)
    _, mm = jax.jit(lambda v: j_execute(prep.graph, prep.params_fp, v, capture="minmax"))(
        jnp.asarray(x))
    ranges = {k: (float(lo), float(hi)) for k, (lo, hi) in mm.items()}
    assert set(ranges) == set(quant_sites(prep.graph))
    if "c2" in unlowered:
        ranges.pop("c2:in0")
    p2 = PreparedModel(prep.graph, prep.params, ranges, prep.cfg, prep.params_fp)
    model = j_lower_int8(p2)
    for name in unlowered:
        model.layers.pop(name, None)
    return prep, model


@pytest.mark.parametrize("build", [_int8_ops_graph, _fallback_graph])
def test_fused_engine_ops_match_jax(build):
    graph, unlowered = build()
    prep, model = _small_model(graph, unlowered)
    rng = np.random.default_rng(6)
    x = np.clip(rng.normal(0, 1, (2, 16, 16, 3)), -2.117, 2.64).astype(np.float32)
    want = jax.jit(lambda v: execute_int8_fused(
        model, prep.params, v, use_pallas=True, fuse_blocks=True))(jnp.asarray(x))
    want = [np.asarray(w) for w in (want if isinstance(want, tuple) else (want,))]
    net = Int8FusedNet(int8_model_from_jax(model), device="cpu",
                       params_f32=params_from_jax(prep.params))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    got = [g.numpy() for g in (got if isinstance(got, tuple) else (got,))]
    for g, w in zip(got, want):
        assert g.shape == w.shape and np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[0].argmax(-1), want[0].argmax(-1))
    assert set(unlowered).isdisjoint(model.layers)


def test_int8_ops_stay_int8():
    """In the int8-ops graph, the max pool, the pad and the concat carry
    int8 tensors (no f32 round trip)."""
    graph, _ = _int8_ops_graph()
    _, model = _small_model(graph, set())
    net = Int8FusedNet(int8_model_from_jax(model), device="cpu")
    for name in ("mp", "pd", "cat"):
        assert net._grids[name] is not None, name
