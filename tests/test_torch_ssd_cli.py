"""The port's detection entry point (``dfq_tpu_torch.cli.run_ssd``) on the
CPU: on a synthetic Pascal VOC tree against the JAX package's CLI (the
same mAP within 1e-6, and the same detections image by image), host and
device NMS against each other, and the smoke run of each engine.

With random weights every detection misses the tree's boxes, so the mAP
alone says little (both print 0.0); the detections the two predictors
return for each image are compared too, recorded around ``eval_map``.
Both CLIs run with ``--device-nms``: its order on tied scores (lower
prior index first) is specified in both packages, where JAX's host path
leaves it to ``np.argsort``.
"""

import json
import sys
import xml.etree.ElementTree as ET

import numpy as np
import pytest
import torch

from dfq_tpu.cli import run_ssd as j_run_ssd
from dfq_tpu_torch.cli import run_ssd

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


def _record_predictions(module, monkeypatch):
    """Wrap ``module.eval_map`` so that every prediction it asks for is
    also kept."""
    seen = []
    orig = module.eval_map

    def eval_map(dataset, predictor, *a, **k):
        predict = predictor.predict

        def recorded(image):
            seen.append(predict(image))
            return seen[-1]

        predictor.predict = recorded
        return orig(dataset, predictor, *a, **k)

    monkeypatch.setattr(module, "eval_map", eval_map)
    return seen


@pytest.mark.parametrize("engine", ["int8", "fused"])
def test_run_ssd_matches_jax(engine, voc_tree, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    args = ["--quantize", "--relu", "--equalize", "--engine", engine, "--data-dir", voc_tree,
            "--limit", "2", "--2007_metric", "--device-nms"]
    want_dets = _record_predictions(j_run_ssd, monkeypatch)
    monkeypatch.setattr(sys, "argv", ["run_ssd"] + args)
    j_run_ssd.main()
    want = float(capsys.readouterr().out.split("mAP: ")[1].split()[0])
    dets = _record_predictions(run_ssd, monkeypatch)
    out = run_ssd.main(args + ["--device", "cpu", "--log"])
    assert f"mAP: {out['mAP']}" in capsys.readouterr().out
    assert abs(out["mAP"] - want) <= 1e-6, (out["mAP"], want)
    logged = json.loads((tmp_path / "ssd_result.txt").read_text().splitlines()[-1])
    assert logged["engine"] == engine and logged["2007"] is True and logged["mAP"] == out["mAP"]
    assert len(dets) == len(want_dets) == 2
    checked = total = 0
    for got, ref in zip(dets, want_dets):
        n, m = _same_until_a_tie(got, [np.asarray(a) for a in ref])
        checked, total = checked + n, total + m
    # int8 confidences tie often: measured on the CPU, 147-151 of 4262
    # detections come before their class's first tie
    assert total > 200 and checked >= 50, (checked, total)


def _same_until_a_tie(got, want):
    """Equal scores are taken in prior order by both packages, but the two
    softmaxes round differently in the last bit, so scores that tie in one
    package can differ by an ulp in the other and be taken in the other
    order; the other pick then suppresses other boxes. Class by class, the
    two pick sequences must be the same up to the first score within 1e-6
    of another score of its class. Returns (detections held, all)."""
    (b, l, p), (wb, wl, wp) = got, want
    assert set(l) == set(wl)
    checked = 0
    for c in np.unique(l):
        mine, theirs = np.nonzero(l == c)[0], np.nonzero(wl == c)[0]
        for k in range(min(len(mine), len(theirs))):
            pk = p[mine]
            if (np.abs(pk - pk[k]) <= 1e-6).sum() > 1:
                break
            assert abs(p[mine[k]] - wp[theirs[k]]) <= 1e-6, (c, k)
            np.testing.assert_allclose(b[mine[k]], wb[theirs[k]], rtol=1e-5, atol=1e-3)
            checked += 1
        else:
            assert len(mine) == len(theirs), c
    return checked, len(l)


def test_host_and_device_nms_agree(voc_tree, monkeypatch):
    """One model and the same images: host and device NMS return the same
    detections in the same order, on int8 confidences that tie often."""
    args = DFQ + ["--engine", "int8", "--data-dir", voc_tree, "--limit", "2"]
    host = _record_predictions(run_ssd, monkeypatch)
    m_host = run_ssd.main(args)["mAP"]
    dev = _record_predictions(run_ssd, monkeypatch)
    assert run_ssd.main(args + ["--device-nms"])["mAP"] == m_host
    for (b, l, p), (db, dl, dp) in zip(host, dev):
        np.testing.assert_array_equal(l, dl)
        np.testing.assert_array_equal(p, dp)
        np.testing.assert_allclose(b, db, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("engine", ["sim", "int8", "fused"])
def test_run_ssd_smoke(engine, capsys):
    out = run_ssd.main(DFQ + ["--engine", engine])
    assert out["conf"].shape == (2, 3000, 21) and out["loc"].shape == (2, 3000, 4)
    np.testing.assert_allclose(out["conf"].sum(-1), 1.0, atol=1e-4)
    boxes, labels, probs = out["detections"]
    assert len(labels) > 0 and boxes.shape == (len(labels), 4)
    assert ("smoke eval ok: conf (2, 3000, 21), loc (2, 3000, 4), finite=True, detections "
            f"{len(labels)} (host NMS)") in capsys.readouterr().out
