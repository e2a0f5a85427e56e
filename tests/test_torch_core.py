"""The port's host layers vs the JAX package: graph IR, quantization math,
Gaussian moments, parameter init, import isolation, device selection."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
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
        # the form XLA compiles it into under jit (reciprocal multiply, FMA)
        want = np.asarray(jax.jit(lambda t: jcore.fake_quant(t, lo, hi, bits, symmetric))(
            jnp.asarray(x)))
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


@pytest.mark.parametrize("bits,symmetric,per_channel", [(8, False, False), (8, True, True),
                                                         (4, True, False), (6, False, True)])
def test_qspec_equal(bits, symmetric, per_channel):
    import dataclasses

    import dfq_tpu_torch

    t = dfq_tpu_torch.QSpec(bits, symmetric, per_channel)
    j = jcore.QSpec(bits, symmetric, per_channel)
    assert (t.qmin, t.qmax) == (j.qmin, j.qmax)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dfq_tpu_torch.fake_quant is tcore.fake_quant
    assert dfq_tpu_torch.quant_params is tcore.quant_params


def test_range_qparams_equal():
    rng = np.random.default_rng(7)
    for lo, hi in [(-1.0, 1.0), (0.0, 6.0), (-0.3, 5.7), (-2.5e-3, 1e-3), (0.0, 0.0),
                   (-7.0, -1.0), (1.0, 3.0)]:
        for bits in (4, 6, 8):
            assert tcore.affine_qparams_from_range(lo, hi, bits) == \
                jcore.affine_qparams_from_range(lo, hi, bits)
            assert tcore.symmetric_scale_from_range(lo, hi, bits) == \
                jcore.symmetric_scale_from_range(lo, hi, bits)
    mn, mx = rng.normal(0, 1, 16) - 2, rng.normal(0, 1, 16) + 2
    np.testing.assert_array_equal(tcore.symmetric_scale_from_range(mn, mx),
                                  jcore.symmetric_scale_from_range(mn, mx))
    w = rng.normal(0, 1, (12, 3, 3, 3)).astype(np.float32)
    for got in (tcore._per_channel_minmax(w),
                [v.numpy() for v in tcore._per_channel_minmax(torch.from_numpy(w))]):
        for g, j in zip(got, jcore._per_channel_minmax(w, np)):
            np.testing.assert_array_equal(g, j)


def test_is_stat_bn_equal():
    from dfq_tpu.passes.fold_bn import fold_batchnorm as j_fold, is_stat_bn as j_is
    from dfq_tpu_torch.passes.fold_bn import fold_batchnorm as t_fold, is_stat_bn as t_is

    g = j_mobilenet_v2()
    params = jcommon.init_params(g, seed=0, bn_stats="random")
    gj, pj = j_fold(g, params)
    gt, pt = t_fold(t_mobilenet_v2(), tcommon.init_params(t_mobilenet_v2(), seed=0,
                                                          bn_stats="random"))
    names = [n.name for n in gj] + ["missing"]
    assert [t_is(pt, n) for n in names] == [j_is(pj, n) for n in names]
    assert sum(t_is(pt, n) for n in names) == sum(1 for n in gt if n.op == "bn") > 0


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
        "import dfq_tpu_torch.graph.executor, dfq_tpu_torch.io, dfq_tpu_torch.cli.run_cls\n"
        "import dfq_tpu_torch.data, dfq_tpu_torch.models.resnet\n"
        "import dfq_tpu_torch.detection, dfq_tpu_torch.detection.device_nms\n"
        "import dfq_tpu_torch.metrics, dfq_tpu_torch.data.voc, dfq_tpu_torch.models.ssd\n"
        "import dfq_tpu_torch.models.deeplab, dfq_tpu_torch.cli.run_ssd\n"
        "import dfq_tpu_torch.cli.run_seg\n"
        "import dfq_tpu_torch.calib, dfq_tpu_torch.calib.distill, dfq_tpu_torch.calib.calibrate\n"
        "import dfq_tpu_torch.calib.recon, dfq_tpu_torch.calib.distill_correct\n"
        "import dfq_tpu_torch.passes.learned_scale, dfq_tpu_torch.cli.run_zeroq\n"
        "import dfq_tpu_torch.io.native_export, dfq_tpu_torch.io.checkpoint\n"
        "import dfq_tpu_torch.io.aot, dfq_tpu_torch.engine.native, dfq_tpu_torch.cli.convert\n"
        "import dfq_tpu_torch.models.alexnet, dfq_tpu_torch.models.xception\n"
        "import dfq_tpu_torch.models.drn, dfq_tpu_torch.models.ssd_variants\n"
        "import dfq_tpu_torch.data.open_images\n"
        "import dfq_tpu_torch.parallel, dfq_tpu_torch.parallel.multihost\n"
        "import dfq_tpu_torch.detection.losses, dfq_tpu_torch.detection.transforms\n"
        "import dfq_tpu_torch.data.seg_transforms\n"
        "import dfq_tpu_torch.engine.autotune, dfq_tpu_torch.utils\n"
        "import dfq_tpu_torch.utils.profiling, dfq_tpu_torch.utils.visualize\n"
        "from dfq_tpu_torch import QSpec, fake_quant, quant_params\n"
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
