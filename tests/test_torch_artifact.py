"""The port's int8 artifact (``dfq_tpu_torch.io``, format 1: ``manifest.json``
plus ``tensors.npz``) against the JAX package's: a round trip, artifacts
crossing between the two packages in both directions with equal tensors
and manifests, and the committed golden artifact (``golden/``) through the
port's engines on the CPU (``tests/test_golden_artifact.py``'s limits:
the baseline engine ``rtol=0, atol=1e-5`` with equal argmax, the fused
engine equal argmax)."""

import json
import os

import numpy as np
import pytest
import torch

from dfq_tpu.engine.int8 import lower_int8 as j_lower_int8
from dfq_tpu.io import load_artifact as j_load_artifact
from dfq_tpu.io import save_artifact as j_save_artifact
from dfq_tpu.models.common import init_params as j_init_params
from dfq_tpu.models.resnet import resnet18 as j_resnet18
from dfq_tpu.pipeline import QuantConfig, prepare
from dfq_tpu_torch.engine import Int8FusedNet, Int8Net
from dfq_tpu_torch.interop import int8_model_from_jax, params_from_jax
from dfq_tpu_torch.io import load_artifact, save_artifact

torch.set_num_threads(1)
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "golden")


@pytest.fixture(scope="module")
def lowered():
    g = j_resnet18()
    prep = prepare(g, j_init_params(g, seed=0, bn_stats="random"),
                   QuantConfig(quantize=True, relu=True, equalize=True, bits_bias=16))
    model = j_lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model.layers}
    return model, residual


def _same(a, pa, b, pb):
    assert [(n.name, n.op, tuple(n.inputs), n.attrs) for n in a.graph] == [
        (n.name, n.op, tuple(n.inputs), n.attrs) for n in b.graph]
    assert tuple(a.graph.outputs) == tuple(b.graph.outputs)
    assert a.bits_act == b.bits_act and a.layers.keys() == b.layers.keys()
    assert {k: tuple(v) for k, v in a.act_ranges.items()} == {
        k: tuple(v) for k, v in b.act_ranges.items()}
    for name, la in a.layers.items():
        lb = b.layers[name]
        for f in ("qweight", "w_scale", "wsum", "bias"):
            x, y = getattr(la, f), getattr(lb, f)
            assert (x is None) == (y is None), (name, f)
            if x is not None:
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and np.array_equal(x, y), (name, f)
        assert (la.in_scale, la.in_zp) == (lb.in_scale, lb.in_zp)
    assert pa.keys() == pb.keys()
    for k in pa:
        assert pa[k].keys() == pb[k].keys()
        for n in pa[k]:
            assert np.array_equal(np.asarray(pa[k][n]), np.asarray(pb[k][n])), (k, n)


def test_round_trip(lowered, tmp_path):
    model, residual = int8_model_from_jax(lowered[0]), params_from_jax(lowered[1])
    save_artifact(str(tmp_path), model, residual)
    m2, p2 = load_artifact(str(tmp_path))
    _same(model, residual, m2, p2)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_artifacts_cross_between_packages(lowered, tmp_path, writer):
    jm, jp = lowered
    a, b = tmp_path / "a", tmp_path / "b"
    if writer == "jax":
        j_save_artifact(str(a), jm, jp)
        got, gp = load_artifact(str(a))
        save_artifact(str(b), got, gp)
    else:
        save_artifact(str(a), int8_model_from_jax(jm), params_from_jax(jp))
        got, gp = j_load_artifact(str(a))
        j_save_artifact(str(b), got, gp)
    _same(jm, jp, got, gp)
    # the same manifest and the same tensors, whoever wrote them
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    assert ma == mb
    ta, tb = (np.load(d / "tensors.npz") for d in (a, b))
    assert sorted(ta.files) == sorted(tb.files)
    assert all(ta[k].dtype == tb[k].dtype and np.array_equal(ta[k], tb[k]) for k in ta.files)


def test_golden_artifact_on_the_port():
    x = torch.from_numpy(np.load(os.path.join(GOLDEN, "input.npy")))
    want = np.load(os.path.join(GOLDEN, "logits.npy"))
    model, residual = load_artifact(os.path.join(GOLDEN, "artifact"))
    with torch.no_grad():
        got = Int8Net(model, residual, device="cpu")(x).numpy()
        fused = Int8FusedNet(model, device="cpu", params_f32=residual)(x).numpy()
    assert got.shape == want.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert np.isfinite(fused).all()
    np.testing.assert_array_equal(fused.argmax(-1), want.argmax(-1))
