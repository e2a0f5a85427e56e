"""The depthwise-policy autotuner on the port (``dfq_tpu_torch/engine/autotune.py``)
against the JAX package's (``dfq_tpu/engine/autotune.py``), on the CPU:
the machinery, not a margin (a CPU race says nothing of the card's).

- the candidates equal JAX's; the signature is stable, ignores weight
  values and changes with the batch, the device name and the schema
  version;
- a race picks a candidate, reports every candidate's time with its
  spread, and caches the winner; the next call is a hit; a candidate list
  of one, or an ``executor`` that makes the others slow, forces a winner;
- a missing, corrupt or truncated cache, or an entry whose label is not a
  candidate, races again without raising; the write is atomic (a write
  that fails midway leaves the old file as it was, and no temporary
  file); ``cache_path=None`` writes nothing;
- the winner's policy runs and gives the default net's logits bit for bit.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

import dfq_tpu.engine.autotune as jat
from dfq_tpu.engine.int8 import lower_int8 as j_lower_int8
from dfq_tpu.graph import GraphBuilder
from dfq_tpu.models import init_params as j_init_params
from dfq_tpu.pipeline import QuantConfig, prepare
import dfq_tpu_torch.engine.autotune as tat
from dfq_tpu_torch.engine import (Int8FusedNet, autotune_dw_policy, dw_policy_candidates,
                                  model_signature)
from dfq_tpu_torch.interop import int8_model_from_jax

torch.set_num_threads(1)
LABELS = {"auto", "dense32_h160", "grouped"}


def _tiny_dw_net():
    """Stem conv + dw block + classifier (the JAX autotune test's graph)."""
    b = GraphBuilder()
    x = b.input("data")
    x = b.conv("stem.0", x, 3, 16, (3, 3), stride=(2, 2), padding=(1, 1))
    x = b.bn("stem.1", x, 16)
    x = b.relu("stem.2", x)
    x = b.conv("blk.0", x, 16, 16, (3, 3), padding=(1, 1), groups=16)
    x = b.bn("blk.1", x, 16)
    x = b.relu("blk.2", x)
    x = b.conv("blk.3", x, 16, 32, (1, 1))
    x = b.bn("blk.4", x, 32)
    x = b.relu("blk.5", x)
    x = b.global_mean("pool", x)
    x = b.linear("classifier", x, 32, 10)
    return b.build([x])


@pytest.fixture(scope="module")
def tiny():
    graph = _tiny_dw_net()
    prep = prepare(graph, j_init_params(graph, seed=0, bn_stats="random"),
                   QuantConfig(quantize=True, relu=True, bits_bias=16))
    jmodel = j_lower_int8(prep)
    model = int8_model_from_jax(jmodel)
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, (2, 32, 32, 3))
                         .astype(np.float32))
    with torch.no_grad():
        default = Int8FusedNet(model, device="cpu")(x)
    return jmodel, model, x, default


def _race(model, x, path=None, **kw):
    return autotune_dw_policy(model, {}, x, cache_path=None if path is None else str(path),
                              rounds=2, reps=1, **kw)


def test_candidates_equal_jax():
    for b in (1, 8, 128):
        assert dw_policy_candidates(b) == jat.dw_policy_candidates(b)
    assert {c["_label"] for c in dw_policy_candidates(8)} == LABELS


def test_signature_stable_and_keyed(tiny, monkeypatch):
    jmodel, model, _, _ = tiny
    sig = model_signature(model, 8, device="cpu")
    assert sig == model_signature(model, 8, device="cpu") and len(sig) == 16
    assert sig != model_signature(model, 32, device="cpu")
    assert sig != model_signature(model, 8, extra="x", device="cpu")
    # weight values do not enter it
    other = int8_model_from_jax(jmodel)
    for layer in other.layers.values():
        layer.qweight = -layer.qweight
    assert model_signature(other, 8, device="cpu") == sig
    monkeypatch.setattr(tat, "device_name", lambda device=None: "NVIDIA H100 80GB HBM3")
    assert model_signature(model, 8, device="cpu") != sig
    monkeypatch.undo()
    monkeypatch.setattr(tat, "SCHEMA_VERSION", tat.SCHEMA_VERSION + "-next")
    assert model_signature(model, 8, device="cpu") != sig
    assert tat.device_name("cpu") == "cpu"


def test_race_picks_reports_and_caches(tiny, tmp_path):
    _, model, x, default = tiny
    cache = tmp_path / "sub" / "autotune.json"
    pol, report = _race(model, x, cache)
    assert not report["cached"] and report["label"] in LABELS
    assert report["device"] == "cpu"
    assert [r["label"] for r in report["rows"]] == ["auto", "dense32_h160", "grouped"]
    for r in report["rows"]:
        assert 0 < r["ms_min"] <= r["ms"] <= r["ms_max"]
    assert report["ms"] == min(r["ms"] for r in report["rows"])
    with torch.no_grad():
        out = Int8FusedNet(model, device="cpu", **pol)(x)
    np.testing.assert_array_equal(out.numpy(), default.numpy())
    pol2, report2 = _race(model, x, cache)
    assert report2["cached"] and report2["label"] == report["label"] and pol2 == pol
    data = json.loads(cache.read_text())
    assert set(data) == {model_signature(model, 2, device="cpu")}
    assert os.listdir(cache.parent) == ["autotune.json"]


def test_forced_winner(tiny):
    _, model, x, _ = tiny
    pol, report = _race(model, x, candidates=[{"_label": "grouped", "dw_dense_max_ch": 0}])
    assert report["label"] == "grouped" and pol == {"dw_dense_max_ch": 0}

    def executor(model, params, v, per_device_batch=None, **policy):
        if policy != {"dw_dense_max_ch": 32, "dw_dense_max_h": 160}:
            time.sleep(0.02)
        return Int8FusedNet(model, device="cpu", per_device_batch=per_device_batch,
                            **policy)(v)

    pol, report = _race(model, x, executor=executor)
    assert report["label"] == "dense32_h160"
    assert pol == {"dw_dense_max_ch": 32, "dw_dense_max_h": 160}


@pytest.mark.parametrize("content", ["", "{not json", '{"a": {"label": "auto", "ms"', "[1, 2]",
                                     "stale"])
def test_bad_cache_races_again(tiny, tmp_path, content):
    _, model, x, _ = tiny
    cache = tmp_path / "autotune.json"
    if content == "stale":
        # a hit whose label is not among the candidates is ignored
        content = json.dumps({model_signature(model, 2, device="cpu"): {"label": "old",
                                                                         "ms": 1.0}})
    cache.write_text(content)
    _, report = _race(model, x, cache)
    assert not report["cached"] and len(report["rows"]) == 3
    entry = json.loads(cache.read_text())[model_signature(model, 2, device="cpu")]
    assert entry["label"] == report["label"]


def test_truncated_cache_races_again(tiny, tmp_path):
    _, model, x, _ = tiny
    cache = tmp_path / "autotune.json"
    _race(model, x, cache)
    full = cache.read_text()
    cache.write_text(full[: len(full) // 2])
    _, report = _race(model, x, cache)
    assert not report["cached"]
    assert json.loads(cache.read_text())


def test_cache_write_is_atomic(tiny, tmp_path, monkeypatch):
    _, model, x, _ = tiny
    cache = tmp_path / "autotune.json"
    old = json.dumps({"other-model": {"label": "grouped", "ms": 2.0}}, indent=1)
    cache.write_text(old)

    def broken_dump(obj, f, **kw):
        f.write('{"half": ')
        raise OSError("disk full")

    monkeypatch.setattr(tat.json, "dump", broken_dump)
    with pytest.raises(OSError, match="disk full"):
        _race(model, x, cache)
    assert cache.read_text() == old
    assert os.listdir(tmp_path) == ["autotune.json"]
    monkeypatch.undo()
    _race(model, x, cache)
    data = json.loads(cache.read_text())
    assert set(data) == {"other-model", model_signature(model, 2, device="cpu")}


def test_no_cache_path_writes_nothing(tiny, tmp_path, monkeypatch):
    _, model, x, _ = tiny
    monkeypatch.chdir(tmp_path)
    _, report = _race(model, x)
    assert not report["cached"] and os.listdir(tmp_path) == []
