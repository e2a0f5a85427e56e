"""Calibration through the port's entry points on the CPU: ``run_cls``,
``run_ssd``, ``run_seg`` with ``--quantize --distill_range`` (and
``run_cls --true_data``), and ``run_zeroq``.

The distillation's step budget is capped by replacing ``distill_data`` in
the entry point's namespace with one that forces ``max_iters`` (no flag of
the JAX entry points sets it). The ranges an entry point sets must equal
``calibrate_ranges`` on the batches it distilled; ``run_cls``'s fused
forward under those ranges equals the JAX fused engine's
(``lower_int8`` -> ``execute_int8_fused``, Pallas in interpret mode) within
the JAX suite's ``atol=1e-4``, and the port's calibration on those batches
is close to JAX's per site (bounded below). Also the flags JAX ignores
where they do not apply.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfq_tpu.calib import calibrate_ranges as j_calibrate_ranges
from dfq_tpu.engine.int8 import lower_int8 as j_lower_int8
from dfq_tpu.engine.int8_fused import execute_int8_fused
from dfq_tpu.models.common import init_params as j_init_params
from dfq_tpu.models.mobilenet_v2 import mobilenet_v2 as j_mobilenet_v2
from dfq_tpu.pipeline import QuantConfig as JQuantConfig
from dfq_tpu.pipeline import prepare as j_prepare
from dfq_tpu_torch.calib import calibrate_ranges
from dfq_tpu_torch.cli import run_cls, run_seg, run_ssd, run_zeroq
from dfq_tpu_torch.models import init_params, mobilenet_v2
from dfq_tpu_torch.pipeline import QuantConfig, prepare

torch.set_num_threads(1)
DFQ = ["--quantize", "--relu", "--equalize", "--device", "cpu"]
DIS = ["--distill_range", "--dis_batch_size", "2", "--dis_num_batch", "1"]


def _cap(module, monkeypatch, iters=2):
    """Cap ``module``'s distillation at ``iters`` steps; returns a dict that
    receives its config and batches."""
    real = module.distill_data
    seen = {}

    def capped(graph, params, cfg, **kw):
        seen["cfg"] = dataclasses.replace(cfg, max_iters=iters)
        seen["batches"] = real(graph, params, seen["cfg"], **kw)
        return seen["batches"]

    monkeypatch.setattr(module, "distill_data", capped)
    return seen


def _port_prep(**flags):
    graph = mobilenet_v2()
    return prepare(graph, init_params(graph, seed=0, bn_stats="random"),
                   QuantConfig(quantize=True, relu=True, equalize=True, distill_range=True,
                               **flags))


def test_run_cls_distill_range_fused_matches_jax(monkeypatch, capsys):
    seen = _cap(run_cls, monkeypatch)
    out = run_cls.main(DFQ + DIS + ["--engine", "fused"])
    assert "smoke eval ok: logits shape (8, 1000), finite=True" in capsys.readouterr().out
    cfg = seen["cfg"]
    assert (cfg.batch_size, cfg.num_batch, cfg.image_size, cfg.early_break_factor) == (
        2, 1, (224, 224), 0.5)
    (batch,) = seen["batches"]
    assert batch.shape == (2, 224, 224, 3) and np.isfinite(batch).all()
    # the ranges the entry point lowered with are calibrate_ranges' on its
    # batches
    prep = _port_prep()
    ranges = calibrate_ranges(prep.graph, prep.params, seen["batches"], device="cpu")
    assert out["model"].act_ranges == ranges
    # the JAX package's calibration on the same batches: the self-quant
    # forwards of the whole network flip fake-quant ties, which later
    # sites carry on (the simulator's divergence, ROADMAP.md section 3):
    # most sites within one fake-quant step, every one within 2% of its
    # span (measured: 0.8%)
    g = j_mobilenet_v2()
    jprep = j_prepare(g, j_init_params(g, seed=0, bn_stats="random"),
                      JQuantConfig(quantize=True, relu=True, equalize=True, distill_range=True))
    j_ranges = j_calibrate_ranges(jprep.graph, jprep.params, seen["batches"])
    assert j_ranges.keys() == ranges.keys()
    span = {s: hi - lo for s, (lo, hi) in j_ranges.items()}
    err = {s: max(abs(a - b) for a, b in zip(ranges[s], j_ranges[s])) for s in j_ranges}
    within_step = sum(err[s] <= span[s] / 255.0 for s in err)
    print(f"sites within a step: {within_step} of {len(err)}; largest share of span "
          f"{max(err[s] / span[s] for s in err)}")
    assert within_step >= 0.9 * len(err)
    assert all(err[s] <= 0.02 * span[s] for s in err), err
    # the JAX fused engine under the same ranges, on the same images
    jprep.act_ranges = ranges
    model = j_lower_int8(jprep)
    x = np.random.default_rng(0).normal(0, 1, (8, 224, 224, 3)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: execute_int8_fused(
        model, jprep.params, v, use_pallas=True, fuse_blocks=True))(jnp.asarray(x)))
    got = out["logits"]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.fixture(scope="module")
def imagenet_tree(tmp_path_factory):
    """A copy of ``tests/test_data_and_cli.py``'s ``imagenet_tree``."""
    from PIL import Image

    root = tmp_path_factory.mktemp("imagenet_val")
    rng = np.random.default_rng(0)
    for cls in ("n01440764", "n01443537"):
        d = root / cls
        d.mkdir()
        for i in range(3):
            Image.fromarray(rng.integers(0, 255, (256, 300, 3), np.uint8)).save(
                d / f"img_{i}.jpg")
    return str(root)


def test_run_cls_true_data(imagenet_tree, monkeypatch, capsys):
    from dfq_tpu_torch.data import imagenet_batches

    monkeypatch.setattr(run_cls, "distill_data", None)  # real images only
    out = run_cls.main(DFQ + ["--distill_range", "--true_data", "--data-dir", imagenet_tree,
                              "--dis_batch_size", "2", "--dis_num_batch", "2", "--engine",
                              "int8", "--batch-size", "3", "--limit", "3"])
    assert "Acc:" in capsys.readouterr().out and 0.0 <= out["acc"] <= 1.0
    batches = [imgs for imgs, _ in imagenet_batches(imagenet_tree, 2, limit=4)]
    prep = _port_prep()
    assert out["model"].act_ranges == calibrate_ranges(prep.graph, prep.params, batches,
                                                       device="cpu")


def test_run_ssd_distill_range(monkeypatch):
    seen = _cap(run_ssd, monkeypatch)
    out = run_ssd.main(DFQ + DIS + ["--engine", "fused"])
    cfg = seen["cfg"]
    assert (cfg.image_size, cfg.value_range, cfg.max_value, cfg.early_break_factor) == (
        (300, 300), (-1.0, 1.0), 1.0, 0.04)
    assert np.isfinite(out["conf"]).all() and np.isfinite(out["loc"]).all()
    from dfq_tpu_torch.models import mobilenet_v2_ssd_lite

    graph = mobilenet_v2_ssd_lite(num_classes=21)
    prep = prepare(graph, init_params(graph, seed=0, bn_stats="random"),
                   QuantConfig(quantize=True, relu=True, equalize=True, distill_range=True,
                               delete_single=True, is_detection=True))
    ranges = calibrate_ranges(prep.graph, prep.params, seen["batches"], is_detection=True,
                              device="cpu")
    assert out["model"].act_ranges == ranges
    assert ranges["base_net.0.0:in0"] == (-1.0, 1.0)


def test_run_seg_distill_range(monkeypatch):
    seen = _cap(run_seg, monkeypatch)
    out = run_seg.main(DFQ + DIS + ["--engine", "int8", "--crop-size", "129"])
    cfg = seen["cfg"]
    assert (cfg.image_size, cfg.early_break_factor) == ((129, 129), 0.2)
    assert np.isfinite(out["output"]).all()
    from dfq_tpu_torch.models import deeplab_mobilenet_v2

    graph = deeplab_mobilenet_v2(input_size=129)
    prep = prepare(graph, init_params(graph, seed=0, bn_stats="random"),
                   QuantConfig(quantize=True, relu=True, equalize=True, distill_range=True))
    assert out["model"].act_ranges == calibrate_ranges(prep.graph, prep.params,
                                                       seen["batches"], device="cpu")


def test_run_zeroq(monkeypatch, capsys):
    seen = _cap(run_zeroq, monkeypatch)
    out = run_zeroq.main(["--model", "resnet18", "--device", "cpu", "--dis_batch_size", "2",
                          "--dis_num_batch", "1", "--image-size", "32"])
    assert "smoke eval ok: logits (8, 1000), finite=True" in capsys.readouterr().out
    assert seen["cfg"].early_break_factor == 1.0 and seen["cfg"].image_size == (32, 32)
    from dfq_tpu_torch.models import resnet18
    from dfq_tpu_torch.passes import fold_batchnorm, quantize_layer_weights

    graph = resnet18()
    gf, pf = fold_batchnorm(graph, init_params(graph, seed=0, bn_stats="random"))
    pq = quantize_layer_weights(gf, pf, bits_weight=8, bits_bias=32, per_channel=True)
    assert out["act_ranges"] == calibrate_ranges(gf, pq, seen["batches"], device="cpu")


# -- the flags JAX ignores where they do not apply ---------------------------

def test_distill_range_ignored_without_quantize(monkeypatch):
    monkeypatch.setattr(run_cls, "distill_data", None)  # must not be reached
    out = run_cls.main(["--distill_range", "--relu", "--device", "cpu"])
    assert out["logits"].shape == (8, 1000) and np.isfinite(out["logits"]).all()


def test_true_data_requires_data_dir(monkeypatch):
    monkeypatch.setattr(run_cls, "distill_data", None)
    with pytest.raises(SystemExit, match="--true_data requires --data-dir"):
        run_cls.main(DFQ + ["--distill_range", "--true_data"])


@pytest.mark.parametrize("flags", [["--stream"], ["--true_data"]], ids=["stream", "true_data"])
def test_ignored_without_their_inputs(flags):
    """``--stream`` without ``--data-dir``, and ``--true_data`` without
    ``--distill_range``, change nothing: the run equals the plain one."""
    out = run_cls.main(DFQ + ["--resnet", "--engine", "fused"] + flags)
    plain = run_cls.main(DFQ + ["--resnet", "--engine", "fused"])
    assert np.array_equal(out["logits"], plain["logits"])
