"""``dfq_tpu_torch.io.checkpoint``: the API of ``dfq_tpu/io/checkpoint.py``
(``save_params(path, params, act_ranges=None)`` and ``load_params(path)``)
in a format of the port's own (``params.npz`` and ``act_ranges.json``,
loaded without pickle). The round trip is exact: every array's dtype and
bits, and the ranges as Python floats (``tests/test_parallel.py:194-203``
holds the JAX version to the same contract)."""

import json

import numpy as np
import pytest
import torch

from dfq_tpu_torch.io.checkpoint import load_params, save_params
from dfq_tpu_torch.models import init_params, mobilenet_v2
from dfq_tpu_torch.pipeline import QuantConfig, prepare

torch.set_num_threads(1)


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].keys() == b[k].keys(), k
        for n in a[k]:
            x, y = np.asarray(a[k][n]), b[k][n]
            assert x.dtype == y.dtype and x.shape == y.shape, (k, n)
            assert x.tobytes() == y.tobytes(), (k, n)


def test_round_trip_is_exact(tmp_path):
    g = mobilenet_v2()
    prep = prepare(g, init_params(g, seed=3, bn_stats="random"),
                   QuantConfig(quantize=True, relu=True, equalize=True, bits_bias=16))
    # mixed dtypes, a scalar and a NaN keep their bits too
    params = dict(prep.params)
    params["extra"] = {"i8": np.arange(-5, 5, dtype=np.int8), "i32": np.int32(7),
                       "f64": np.array([np.pi, np.nan]), "empty": np.zeros((0, 3), np.float32)}
    save_params(str(tmp_path / "ckpt"), params, prep.act_ranges)
    p2, r2 = load_params(str(tmp_path / "ckpt"))
    _equal(params, p2)
    assert r2 == prep.act_ranges
    assert all(type(v) is float for lohi in r2.values() for v in lohi)


def test_same_signatures_as_jax():
    import inspect

    from dfq_tpu.io import checkpoint as j

    for fn, jfn in ((save_params, j.save_params), (load_params, j.load_params)):
        assert list(inspect.signature(fn).parameters) == list(inspect.signature(jfn).parameters)


def test_jax_contract(tmp_path):
    """``tests/test_parallel.py::test_checkpoint_roundtrip`` on the port."""
    g = mobilenet_v2()
    p = init_params(g, seed=3, bn_stats="random")
    ranges = {"c1:in0": (-2.0, 2.0)}
    save_params(str(tmp_path / "ckpt"), p, ranges)
    p2, r2 = load_params(str(tmp_path / "ckpt"))
    np.testing.assert_array_equal(p2["features.0.0"]["weight"], p["features.0.0"]["weight"])
    assert r2 == ranges


def test_without_ranges_and_overwrite(tmp_path):
    path = str(tmp_path / "ckpt")
    p = {"fc": {"weight": np.ones((2, 3), np.float32)}}
    save_params(path, p, {"fc:in0": (np.float32(-1.5), np.float64(0.1))})
    assert load_params(path)[1] == {"fc:in0": (-1.5, 0.1)}
    save_params(path, p)  # a later save without ranges leaves none behind
    p2, r2 = load_params(path)
    assert r2 is None
    _equal(p, p2)


def test_files_are_plain(tmp_path):
    path = tmp_path / "ckpt"
    save_params(str(path), {"a.b": {"w": np.ones(2, np.float32)}}, {"a.b:in0": (0.0, 6.0)})
    assert sorted(f.name for f in path.iterdir()) == ["act_ranges.json", "params.npz"]
    assert json.loads((path / "act_ranges.json").read_text()) == {"a.b:in0": [0.0, 6.0]}
    with np.load(path / "params.npz", allow_pickle=False) as d:
        assert d.files == ["a.b::w"]


@pytest.mark.parametrize("bad", [{"a::b": {"w": np.ones(1)}}, {"a": {"w": None}}])
def test_refuses_what_it_cannot_load(tmp_path, bad):
    with pytest.raises(ValueError):
        save_params(str(tmp_path / "ckpt"), bad)
