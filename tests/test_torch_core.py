"""The port's host layers vs the JAX package: graph IR, quantization math,
Gaussian moments, parameter init, import isolation, device selection."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dfq_tpu.graph import ir as jir
from dfq_tpu.models import common as jcommon
from dfq_tpu.models.mobilenet_v2 import mobilenet_v2 as j_mobilenet_v2
from dfq_tpu.quant import core as jcore
from dfq_tpu.quant import moments as jmom
from dfq_tpu_torch.graph import ir as tir
from dfq_tpu_torch.models import common as tcommon
from dfq_tpu_torch.models.mobilenet_v2 import mobilenet_v2 as t_mobilenet_v2
from dfq_tpu_torch.quant import core as tcore
from dfq_tpu_torch.quant import moments as tmom

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _same_graph(a, b):
    assert [(n.name, n.op, tuple(n.inputs), n.attrs) for n in a] == [
        (n.name, n.op, tuple(n.inputs), n.attrs) for n in b
    ]
    assert tuple(a.outputs) == tuple(b.outputs)


@pytest.mark.parametrize("relu6", [True, False])
def test_mobilenet_v2_graph_and_sites_equal(relu6):
    gj = j_mobilenet_v2(relu6=relu6)
    gt = t_mobilenet_v2(relu6=relu6)
    _same_graph(gj, gt)
    assert jir.quant_sites(gj) == tir.quant_sites(gt)
    for nj, nt in zip(gj, gt):
        assert jir.node_sites(nj) == tir.node_sites(nt)
        assert gj.consumers(nj.name) == gt.consumers(nt.name)
    assert gj.fanout() == gt.fanout()
    assert gj.summary() == gt.summary() and gj.to_dot() == gt.to_dot()
    _same_graph(gj.map_ops({"relu6": "relu"}), gt.map_ops({"relu6": "relu"}))


def test_graph_builder_validation():
    b = tir.GraphBuilder()
    x = b.input("data")
    b.relu("r", x)
    with pytest.raises(ValueError, match="unknown output"):
        b.build(["nope"])
    with pytest.raises(ValueError, match="duplicate"):
        tir.Graph([tir.Node("a", "input", ()), tir.Node("a", "relu", ("a",))], ["a"])


@pytest.mark.parametrize("bn_stats", ["random", "identity"])
def test_init_params_byte_identical(bn_stats):
    g = t_mobilenet_v2()
    pj = jcommon.init_params(j_mobilenet_v2(), seed=3, bn_stats=bn_stats)
    pt = tcommon.init_params(g, seed=3, bn_stats=bn_stats)
    assert pj.keys() == pt.keys()
    for k in pj:
        assert pj[k].keys() == pt[k].keys()
        for n in pj[k]:
            assert pj[k][n].dtype == pt[k][n].dtype
            assert pj[k][n].tobytes() == pt[k][n].tobytes(), (k, n)


def test_load_torch_state_dict():
    g = t_mobilenet_v2()
    p = tcommon.init_params(g, seed=1, bn_stats="random")
    sd = {}
    for node in g:
        if node.op in ("conv", "linear"):
            sd[f"{node.name}.weight"] = torch.from_numpy(p[node.name]["weight"])
            if "bias" in p[node.name]:
                sd[f"{node.name}.bias"] = torch.from_numpy(p[node.name]["bias"])
        elif node.op == "bn":
            for tk, ok in (("weight", "gamma"), ("bias", "beta"),
                           ("running_mean", "mean"), ("running_var", "var")):
                sd[f"{node.name}.{tk}"] = torch.from_numpy(p[node.name][ok])
    got = tcommon.load_torch_state_dict(g, sd)
    want = jcommon.load_torch_state_dict(j_mobilenet_v2(), {k: v.numpy() for k, v in sd.items()})
    assert got.keys() == want.keys()
    for k in got:
        for n in got[k]:
            np.testing.assert_array_equal(got[k][n], want[k][n])
    del sd["classifier.weight"]
    with pytest.raises(KeyError, match="classifier.weight"):
        tcommon.load_torch_state_dict(g, sd)


_RANGES = [(-1.3, 2.7), (0.0, 0.0), (-5.0, 1.0), (2.0, 3.0), (-1e-12, 1e-12)]


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("lo,hi", _RANGES)
def test_quant_params_and_fake_quant(lo, hi, symmetric):
    # includes the |max| < |min| swap of symmetric mode and the 1e-8 floor
    for bits in (4, 8):
        sj = jcore.quant_params(lo, hi, bits, symmetric)
        st = tcore.quant_params(lo, hi, bits, symmetric)
        for a, b in zip(sj, st):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        st_t = tcore.quant_params(torch.tensor(lo), torch.tensor(hi), bits, symmetric)
        sj_j = jcore.quant_params(jnp.asarray(lo), jnp.asarray(hi), bits, symmetric)
        for a, b in zip(sj_j, st_t):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6)
        x = np.random.default_rng(bits).normal(0, 3, 4096).astype(np.float32)
        want = np.asarray(jcore.fake_quant(jnp.asarray(x), lo, hi, bits, symmetric))
        got = tcore.fake_quant(torch.from_numpy(x), lo, hi, bits, symmetric).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            tcore.fake_quant_np(x, lo, hi, bits, symmetric),
            jcore.fake_quant_np(x, lo, hi, bits, symmetric),
        )


@pytest.mark.parametrize("symmetric", [False, True])
def test_per_channel_and_int_roundtrip(symmetric):
    w = np.random.default_rng(0).normal(0, 1, (16, 8, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tcore.fake_quant_per_channel(w, 8, symmetric),
        jcore.fake_quant_per_channel(w, 8, symmetric),
    )
    np.testing.assert_allclose(
        tcore.fake_quant_per_channel(torch.from_numpy(w), 8, symmetric).numpy(),
        np.asarray(jcore.fake_quant_per_channel(jnp.asarray(w), 8, symmetric)),
        rtol=0, atol=1e-6,
    )
    x = w.ravel()
    qj = jcore.quantize_int(x, 0.02, -3, -128, 127)
    qt = tcore.quantize_int(x, 0.02, -3, -128, 127)
    np.testing.assert_array_equal(qt, qj)
    np.testing.assert_array_equal(
        tcore.quantize_int(torch.from_numpy(x), 0.02, -3, -128, 127).numpy(), qj)
    np.testing.assert_array_equal(tcore.dequantize_int(qt, 0.02, -3),
                                  jcore.dequantize_int(qj, 0.02, -3))
    np.testing.assert_array_equal(
        tcore.dequantize_int(torch.from_numpy(qt), 0.02, -3).numpy(),
        np.asarray(jcore.dequantize_int(jnp.asarray(qj), 0.02, -3)))


def test_moments_equal():
    rng = np.random.default_rng(0)
    sigma = rng.uniform(0.1, 3, 512)
    mu = rng.normal(0, 2, 512)
    for fm, fv in (("relu_gaussian_mean", "relu_gaussian_var"),
                   ("relu6_gaussian_mean", "relu6_gaussian_var")):
        mj = getattr(jmom, fm)(sigma, mu)
        mt = getattr(tmom, fm)(sigma, mu)
        np.testing.assert_array_equal(mt, mj)  # scipy on both host paths
        np.testing.assert_array_equal(getattr(tmom, fv)(sigma, mu, mt),
                                      getattr(jmom, fv)(sigma, mu, mj))
        # tensor path: torch.special vs jax.scipy.special, f32
        s32, m32 = sigma.astype(np.float32), mu.astype(np.float32)
        mtt = getattr(tmom, fm)(torch.from_numpy(s32), torch.from_numpy(m32)).numpy()
        mjj = np.asarray(getattr(jmom, fm)(jnp.asarray(s32), jnp.asarray(m32)))
        np.testing.assert_allclose(mtt, mjj, rtol=2e-6, atol=2e-6)


def test_import_isolation():
    """The port imports neither jax nor dfq_tpu: with both blocked, its
    packages import and leave neither name in sys.modules."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'dfq_tpu'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import dfq_tpu_torch, dfq_tpu_torch.engine, dfq_tpu_torch.ops\n"
        "import dfq_tpu_torch.ops.cuda_int8, dfq_tpu_torch.engine.int8_fused\n"
        "import dfq_tpu_torch.pipeline, dfq_tpu_torch.models, dfq_tpu_torch.passes\n"
        "import dfq_tpu_torch.serve, dfq_tpu_torch.interop, dfq_tpu_torch.quant\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dfq_tpu')]\n"
        "assert not bad, bad\n"
        "print('isolated')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "isolated" in out.stdout


def test_default_device_is_cuda_and_raises_without_it():
    from dfq_tpu_torch.device import resolve_device
    from dfq_tpu_torch.engine import Int8FusedNet, Int8Model

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device(None)
    model = Int8Model(graph=t_mobilenet_v2(), layers={}, act_ranges={})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Int8FusedNet(model)
    assert resolve_device("cpu") == torch.device("cpu")
