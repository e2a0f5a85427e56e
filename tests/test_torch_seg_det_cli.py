"""The port's segmentation and detection entry points
(``dfq_tpu_torch.cli.run_seg``, ``run_ssd``) on the CPU, on a synthetic
Pascal VOC tree, against the JAX package's CLIs on the same tree: the
data loaders yield equal arrays, ``SegEvaluator`` counts equal matrices,
the printed mIOU and mAP equal the JAX CLIs' within 1e-6, the artifacts
round-trip and cross-load with ``dfq_tpu.io``, and the smoke runs behave as
in ``run_cls``."""

import json
import sys
import xml.etree.ElementTree as ET

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfq_tpu.cli import run_seg as j_run_seg
from dfq_tpu.data.voc import VOCDetection as JVOCDetection
from dfq_tpu.data.voc import VOCSegmentation as JVOCSegmentation
from dfq_tpu.engine.int8_fused import execute_int8_fused
from dfq_tpu.io import load_artifact as j_load_artifact
from dfq_tpu.io import save_artifact as j_save_artifact
from dfq_tpu.metrics import SegEvaluator as JSegEvaluator
from dfq_tpu_torch.cli import run_seg, run_ssd
from dfq_tpu_torch.data.voc import VOCDetection, VOCSegmentation
from dfq_tpu_torch.engine import Int8FusedNet, Int8Net
from dfq_tpu_torch.interop import int8_model_from_jax, params_from_jax
from dfq_tpu_torch.io import load_artifact
from dfq_tpu_torch.metrics import SegEvaluator

torch.set_num_threads(1)
DFQ = ["--quantize", "--relu", "--equalize", "--device", "cpu"]


@pytest.fixture(scope="module")
def voc_tree(tmp_path_factory):
    """A copy of ``tests/test_data_and_cli.py``'s ``voc_tree`` fixture."""
    from PIL import Image

    root = tmp_path_factory.mktemp("voc")
    (root / "JPEGImages").mkdir()
    (root / "SegmentationClass").mkdir()
    (root / "Annotations").mkdir()
    (root / "ImageSets" / "Segmentation").mkdir(parents=True)
    (root / "ImageSets" / "Main").mkdir(parents=True)
    rng = np.random.default_rng(1)
    ids = ["000001", "000002"]
    for img_id in ids:
        arr = rng.integers(0, 255, (220, 260, 3), np.uint8)
        Image.fromarray(arr).save(root / "JPEGImages" / f"{img_id}.jpg")
        mask = rng.integers(0, 21, (220, 260), np.uint8)
        mask[:4, :4] = 255  # void
        Image.fromarray(mask, mode="L").save(root / "SegmentationClass" / f"{img_id}.png")
        ann = ET.Element("annotation")
        for name, box, diff in (("dog", (48, 240, 195, 371), 0),
                                ("person", (8, 12, 352, 498), 1)):
            obj = ET.SubElement(ann, "object")
            ET.SubElement(obj, "name").text = name
            ET.SubElement(obj, "difficult").text = str(diff)
            bb = ET.SubElement(obj, "bndbox")
            for k, v in zip(("xmin", "ymin", "xmax", "ymax"), box):
                ET.SubElement(bb, k).text = str(v)
        ET.ElementTree(ann).write(root / "Annotations" / f"{img_id}.xml")
    (root / "ImageSets" / "Segmentation" / "val.txt").write_text("\n".join(ids) + "\n")
    (root / "ImageSets" / "Main" / "test.txt").write_text("\n".join(ids) + "\n")
    return str(root)


def test_voc_loaders_equal(voc_tree):
    seg, jseg = VOCSegmentation(voc_tree, crop_size=97), JVOCSegmentation(voc_tree, crop_size=97)
    assert len(seg) == len(jseg) == 2
    for i in range(2):
        (x, y), (jx, jy) = seg[i], jseg[i]
        assert x.dtype == jx.dtype and np.array_equal(x, jx)
        assert y.dtype == jy.dtype and np.array_equal(y, jy)
    (xs, ys), = list(seg.batches(batch_size=2))
    assert xs.shape == (2, 97, 97, 3) and ys.shape == (2, 97, 97)
    det, jdet = VOCDetection(voc_tree), JVOCDetection(voc_tree)
    assert det.class_names == jdet.class_names and len(det) == len(jdet) == 2
    for i in range(2):
        (iid, arrs), (jid, jarrs) = det.get_annotation(i), jdet.get_annotation(i)
        assert iid == jid
        for a, b in zip(arrs, jarrs):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert np.array_equal(det.get_image(i), jdet.get_image(i))


def test_seg_evaluator_equal():
    rng = np.random.default_rng(0)
    ev, jev = SegEvaluator(21), JSegEvaluator(21)
    for _ in range(3):
        gt = rng.integers(0, 22, (2, 33, 33))
        gt[gt == 21] = 255
        pred = rng.integers(0, 21, (2, 33, 33))
        ev.add_batch(gt, pred)
        jev.add_batch(gt, pred)
    assert np.array_equal(ev.confusion_matrix, jev.confusion_matrix)
    for f in ("pixel_accuracy", "pixel_accuracy_class", "mean_iou", "fw_iou"):
        assert getattr(ev, f)() == getattr(jev, f)(), f
    with pytest.raises(ValueError):
        ev.add_batch(gt, pred[:1])


def _jax_cli(module, argv, monkeypatch, capsys, key):
    monkeypatch.setattr(sys, "argv", argv)
    module.main()
    out = capsys.readouterr().out
    return float(out.split(key)[1].split(",")[0].split()[0])


class _Recording:
    """``SegEvaluator`` that also keeps what it was given."""

    def __init__(self, cls):
        self.cls, self.batches = cls, []

    def __call__(self, n):
        ev = self.cls(n)
        add = ev.add_batch

        def add_batch(gt, pred):
            self.batches.append((gt.copy(), pred.copy()))
            add(gt, pred)

        ev.add_batch = add_batch
        return ev


@pytest.mark.parametrize("engine", ["int8", "fused"])
def test_run_seg_miou_matches_jax(engine, voc_tree, tmp_path, monkeypatch, capsys):
    """The mIOU equals the JAX CLI's within 1e-6 unless a pixel's top two
    logits are within the engines' tolerance of each other (1e-4 each, so
    a gap of 2e-4): such a near-tie may take the other class in the other
    package. Where the two differ, every differing pixel must be such a
    near-tie in the port's logits, and the port's predictions with JAX's
    class at those pixels must give the JAX CLI's mIOU exactly."""
    import dfq_tpu.metrics
    import dfq_tpu_torch.metrics

    monkeypatch.chdir(tmp_path)
    args = ["--quantize", "--relu", "--equalize", "--correction", "--engine", engine,
            "--data-dir", voc_tree, "--crop-size", "129", "--batch-size", "2"]
    j_rec, t_rec = _Recording(JSegEvaluator), _Recording(SegEvaluator)
    monkeypatch.setattr(dfq_tpu.metrics, "SegEvaluator", j_rec)
    want = _jax_cli(j_run_seg, ["run_seg"] + args, monkeypatch, capsys, "mIOU: ")
    monkeypatch.setattr(dfq_tpu_torch.metrics, "SegEvaluator", t_rec)
    out = run_seg.main(args + ["--device", "cpu", "--log"])
    assert f"mIOU: {out['mIOU']}" in capsys.readouterr().out
    logged = json.loads((tmp_path / "seg_result.txt").read_text().splitlines()[-1])
    assert logged["engine"] == engine and logged["miou"] == out["mIOU"]
    if abs(out["mIOU"] - want) <= 1e-6:
        return
    (gt, jpred), = j_rec.batches
    (_, pred), = t_rec.batches
    imgs, _ = next(VOCSegmentation(voc_tree, crop_size=129).batches(2))
    with torch.no_grad():
        logits = out["forward"](torch.from_numpy(imgs)).numpy()
    diff = np.nonzero(pred != jpred)
    mine = np.take_along_axis(logits, pred[..., None].astype(np.int64), -1)[..., 0]
    theirs = np.take_along_axis(logits, jpred[..., None].astype(np.int64), -1)[..., 0]
    assert 0 < len(diff[0]) <= 10
    assert np.all(mine[diff] - theirs[diff] <= 2e-4), mine[diff] - theirs[diff]
    ev = SegEvaluator(21)
    ev.add_batch(gt, np.where(pred != jpred, jpred, pred))
    assert ev.mean_iou() == want


def _cross_load(tmp_path, x, reload_net, jax_out):
    """The port's artifact reloads in the port bit-equal to the entry
    point's network and loads in ``dfq_tpu.io``; the JAX package's
    artifact of the same model loads in the port."""
    art = str(tmp_path / "art")
    model, residual = load_artifact(art)
    with torch.no_grad():
        again = reload_net(model, residual)(torch.from_numpy(x))
    jm, jr = j_load_artifact(art)
    assert jm.layers.keys() == model.layers.keys() and jm.act_ranges == model.act_ranges
    j_save_artifact(str(tmp_path / "jart"), jm, jr)
    m2, r2 = load_artifact(str(tmp_path / "jart"))
    with torch.no_grad():
        again2 = reload_net(m2, r2)(torch.from_numpy(x))
    for a, b in zip(again if isinstance(again, tuple) else (again,),
                    again2 if isinstance(again2, tuple) else (again2,)):
        assert torch.equal(a, b)
    return again, None if jax_out is None else jax_out(jm, jr)


def test_ssd_artifact_round_trip(tmp_path):
    out = run_ssd.main(DFQ + ["--engine", "int8", "--save-artifact", str(tmp_path / "art")])
    x = np.concatenate([out["predictor"].preprocess(im) for im in run_ssd.smoke_images()])
    # (the two packages' engines on this model: tests/test_torch_ssd.py)
    again, _ = _cross_load(tmp_path, x, lambda m, r: Int8Net(m, r, device="cpu"), None)
    assert np.array_equal(again[0].numpy(), out["conf"])
    assert np.array_equal(again[1].numpy(), out["loc"])
    # and the fused engine on the reloaded artifact matches the entry point's
    model, residual = load_artifact(str(tmp_path / "art"))
    fused = run_ssd.main(DFQ + ["--engine", "fused"])
    with torch.no_grad():
        got = Int8FusedNet(model, device="cpu", params_f32=residual)(torch.from_numpy(x))
    assert np.array_equal(got[0].numpy(), fused["conf"])


def test_seg_artifact_round_trip(tmp_path):
    out = run_seg.main(DFQ + ["--engine", "fused", "--crop-size", "129",
                              "--save-artifact", str(tmp_path / "art")])
    assert out["output"].shape == (1, 129, 129, 21)
    assert np.array_equal(out["classes"], out["output"].argmax(-1))
    x = run_seg.smoke_images(size=129)
    again, want = _cross_load(
        tmp_path, x, lambda m, r: Int8FusedNet(m, device="cpu", params_f32=r),
        lambda m, r: jax.jit(lambda v: execute_int8_fused(
            m, r, v, use_pallas=True, fuse_blocks=True))(jnp.asarray(x)))
    assert np.array_equal(again.numpy(), out["output"])
    np.testing.assert_allclose(again.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_carried_model_matches_entry_point():
    """The JAX CLI's lowered model carried across gives the port's entry
    point's output: both packages build the same network from the seed."""
    from dfq_tpu.engine import lower_int8 as j_lower_int8
    from dfq_tpu.models import deeplab_mobilenet_v2 as j_deeplab
    from dfq_tpu.models import init_params as j_init_params
    from dfq_tpu.pipeline import QuantConfig, prepare

    g = j_deeplab(input_size=129)
    prep = prepare(g, j_init_params(g, seed=0, bn_stats="random"),
                   QuantConfig(quantize=True, relu=True, equalize=True))
    model = j_lower_int8(prep)
    residual = params_from_jax({k: v for k, v in prep.params.items() if k not in model.layers})
    out = run_seg.main(DFQ + ["--engine", "int8", "--crop-size", "129"])
    with torch.no_grad():
        got = Int8Net(int8_model_from_jax(model), residual, device="cpu")(
            torch.from_numpy(run_seg.smoke_images(size=129)))
    assert np.array_equal(got.numpy(), out["output"])


@pytest.mark.parametrize("module", [run_ssd, run_seg])
def test_default_device_is_cuda(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(["--quantize", "--relu", "--equalize", "--engine", "fused"])
