"""The port's f32 fake-quant simulator (``dfq_tpu_torch.graph.execute``) vs
the JAX package's ``execute`` under ``jax.jit``, on full-width
MobileNetV2 and ResNet-18 (64x64, batch 2) and on the ops one at a time.

Both run f32 at full precision, but sum in different orders (XLA:CPU vs
oneDNN), so the whole models are held to tolerances:

- without ``act_ranges``: ``rtol=1e-4, atol=1e-4``;
- with fake-quant sites, per node: each node's output, computed by the
  port from the JAX simulator's own inputs to that node (so every site
  sees the same values on both sides), within ``1e-5 * max|output|``
  (measured at most 2.1e-6, ResNet-18's ``layer4.1.conv1``);
- with fake-quant sites, whole model: equal argmax and a max abs
  difference within ``2e-2 * max|logit|``. A site flips a value that
  sits on a rounding tie by one grid step wherever the two sides' sums
  differ in the last bit, and the flips add up through the network:
  measured 0.0096 of max|logit| 1.06 (MobileNetV2) and 0.074 of 5.80
  (ResNet-18), far above the ``1e-3 * max|logit|`` that an exact
  reproduction would meet; the per-node check is the strict one;
- the capture modes ``rtol=1e-5`` of each captured tensor's largest
  magnitude, resize ``atol=1e-5`` (the JAX suite's own).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfq_tpu.graph.executor import execute as j_execute
from dfq_tpu.graph.ir import Graph as JGraph
from dfq_tpu.graph.ir import GraphBuilder
from dfq_tpu.models.common import init_params as j_init_params
from dfq_tpu.models.mobilenet_v2 import mobilenet_v2 as j_mobilenet_v2
from dfq_tpu.models.resnet import resnet18 as j_resnet18
from dfq_tpu.pipeline import QuantConfig, prepare
from dfq_tpu_torch.graph import execute, node_sites
from dfq_tpu_torch.graph.executor import SITE_OPS, apply_op, layer_params, params_to, site_value
from dfq_tpu_torch.interop import graph_from_jax, params_from_jax

torch.set_num_threads(1)

FLAGSHIP = dict(quantize=True, relu=True, equalize=True, absorption=True,
                correction=True, bits_bias=16)


def _images(n=2, size=64, seed=1):
    rng = np.random.default_rng(seed)
    return np.clip(rng.normal(0, 1, (n, size, size, 3)), -2.117, 2.64).astype(np.float32)


@pytest.fixture(scope="module", params=["mnv2", "r18"])
def prepared(request):
    g = j_mobilenet_v2() if request.param == "mnv2" else j_resnet18()
    return prepare(g, j_init_params(g, seed=0, bn_stats="random"), QuantConfig(**FLAGSHIP))


def _both(prep, x, **kw):
    graph, params = prep.graph, prep.params
    want = jax.jit(lambda v: j_execute(graph, params, v, **kw))(jnp.asarray(x))
    with torch.no_grad():
        got = execute(graph_from_jax(graph), params_from_jax(params), torch.from_numpy(x),
                      device="cpu", **kw)
    return got, want


def _close_logits(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    diff = float(np.abs(got - want).max())
    peak = float(np.abs(want).max())
    assert diff <= 2e-2 * peak, f"max abs {diff}, max|logit| {peak}"
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1),
                                  err_msg=f"max abs {diff}, max|logit| {peak}")
    return diff


def _per_node(prep, x, **kw):
    """Each node of the port from the JAX simulator's inputs to it, through
    the port's own site rule (``site_value``), weight regime
    (``layer_params``) and op (``apply_op``)."""
    names = [n.name for n in prep.graph if n.op != "input"]
    g_all = JGraph(list(prep.graph), names)
    outs = jax.jit(lambda v: j_execute(g_all, prep.params, v, **kw))(jnp.asarray(x))
    env = dict(zip(names, (np.asarray(o) for o in outs)))
    env[prep.graph.input_names()[0]] = x
    params = params_to(params_from_jax(prep.params), "cpu")
    worst = (0.0, "")
    with torch.no_grad():
        for node in graph_from_jax(prep.graph):
            if node.op == "input":
                continue
            ins = [torch.from_numpy(env[i]) for i in node.inputs]
            if node.op in SITE_OPS:
                ins = [site_value(node, i, v, kw.get("act_ranges") or {}, 8,
                                  self_quant=kw.get("self_quant", False), aux={})
                       if i < len(node_sites(node)) else v for i, v in enumerate(ins)]
            p = layer_params(node, params.get(node.name, {}), kw.get("weight_bits"),
                             kw.get("bias_bits", 16))
            got, want = apply_op(node, ins, p).numpy(), env[node.name]
            rel = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
            worst = max(worst, (rel, node.name))
    assert worst[0] <= 1e-5, f"node {worst[1]}: max abs diff {worst[0]} of max|output|"


_REGIMES = {
    "act_ranges": lambda prep: dict(act_ranges=prep.act_ranges),
    "self_quant": lambda prep: dict(self_quant=True),
    "trainable": lambda prep: dict(act_ranges=prep.act_ranges, weight_bits=8, bias_bits=16),
}


def test_float_model_matches(prepared):
    got, want = _both(prepared, _images())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("regime", sorted(_REGIMES))
def test_fake_quant_per_node(prepared, regime):
    """``act_ranges``, ``self_quant`` (each site's range from its batch)
    and the ``--trainable`` regime (weights fake-quantized per forward),
    node by node."""
    _per_node(prepared, _images(seed=2), **_REGIMES[regime](prepared))


def test_fake_quant_model_matches(prepared):
    _close_logits(*_both(prepared, _images(seed=2), act_ranges=prepared.act_ranges))


def test_other_regimes_whole_model():
    """MobileNetV2 end to end under ``self_quant`` (measured max abs 5.4e-7)
    and the ``--trainable`` regime (measured 0.0082 of max|logit| 1.06).
    ResNet-18's ``self_quant`` ranges follow each batch's own extremes,
    which move with the last bit of the sums: it is held per node only,
    as is its trainable regime (XLA folding its weight fake-quants takes
    20 s)."""
    g = j_mobilenet_v2()
    prep = prepare(g, j_init_params(g, seed=0, bn_stats="random"), QuantConfig(**FLAGSHIP))
    got, want = _both(prep, _images(seed=2), self_quant=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    _close_logits(*_both(prep, _images(seed=2), **_REGIMES["trainable"](prep)))


@pytest.mark.parametrize("mode", ["bn_inputs", "minmax", "layer_outputs"])
def test_capture_modes(mode):
    g = j_resnet18()
    params = j_init_params(g, seed=0, bn_stats="random")  # unfolded BN
    x = _images(seed=4)
    want_out, want = jax.jit(lambda v: j_execute(g, params, v, capture=mode))(jnp.asarray(x))
    with torch.no_grad():
        got_out, got = execute(graph_from_jax(g), params_from_jax(params), torch.from_numpy(x),
                               capture=mode, device="cpu")
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), rtol=1e-4, atol=1e-4)
    assert got.keys() == want.keys() and len(got) > 0
    for k in want:
        for a, b in zip(got[k] if isinstance(got[k], tuple) else (got[k],),
                        want[k] if isinstance(want[k], tuple) else (want[k],)):
            b = np.asarray(b)
            np.testing.assert_allclose(a.numpy(), b, rtol=0,
                                       atol=1e-5 * max(float(np.abs(b).max()), 1.0),
                                       err_msg=f"{mode} {k}")


def _op_graph(kind):
    b = GraphBuilder()
    x = b.input("data")
    if kind == "maxpool":
        y = b.maxpool("p", x, window=(3, 3), stride=(2, 2), padding=(1, 1))
    elif kind == "avgpool":
        y = b.avgpool("p", x, window=(3, 3), stride=(2, 2), padding=(1, 1))
    elif kind == "bilinear":
        y = b.interpolate("p", x, size=(29, 13), align_corners=True)
    elif kind == "bilinear_half":
        y = b.interpolate("p", x, size=(29, 13), align_corners=False)
    elif kind == "nearest":
        y = b.interpolate("p", x, scale=2.0, mode="nearest")
    elif kind == "global_pool":
        y = b.global_pool("p", x)
    elif kind == "pad_concat_softmax":
        y = b.pad("pd", x, pads=(1, 2, 0, 3))
        z = b.pad("pz", x, pads=(0, 3, 1, 2))
        y = b.softmax("p", b.concat("c", [y, z]))
    elif kind == "l2norm_permute":
        y = b.l2norm("l2", x, 3)
        y = b.permute_nchw("p", y, perm=(0, 1, 3, 2))
    else:
        y = b.reshape("p", b.relu6("r", x), shape=(-1,))
    return b.build([y])


@pytest.mark.parametrize("kind", ["maxpool", "avgpool", "bilinear", "bilinear_half", "nearest",
                                  "global_pool", "pad_concat_softmax", "l2norm_permute",
                                  "reshape"])
def test_ops_match(kind):
    g = _op_graph(kind)
    params = j_init_params(g, seed=0)
    x = np.random.default_rng(5).normal(0, 2, (2, 11, 7, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: j_execute(g, params, v))(jnp.asarray(x)))
    with torch.no_grad():
        got = execute(graph_from_jax(g), params_from_jax(params), torch.from_numpy(x),
                      device="cpu").numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    g = _op_graph("maxpool")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        execute(graph_from_jax(g), {}, torch.zeros(1, 4, 4, 3))
