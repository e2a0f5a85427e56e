"""The port's detection post-process vs the JAX package's, on seeded
inputs: ``box_utils`` (host numpy; bit-equal), device NMS in torch on the
CPU against JAX's ``decode_nms`` and against the port's host path, the
``Predictor`` on both paths, and the VOC AP functions (bit-equal).

Ties: the JAX host path orders candidates with ``np.argsort(-scores)``,
whose order on equal scores is unspecified; ``lax.top_k`` takes the lower
index first. The port orders both of its paths by descending score, lower
prior index first, so its host and device keep-sets agree on tied int8
confidences too; against JAX they are compared on distinct scores, as
``tests/test_device_nms.py`` compares JAX's two paths.
"""

import numpy as np
import pytest
import torch

from dfq_tpu.detection import box_utils as jb
from dfq_tpu.detection.device_nms import decode_locations as j_decode_locations
from dfq_tpu.detection.device_nms import decode_nms as j_decode_nms
from dfq_tpu.metrics import detection as jmet
from dfq_tpu_torch.detection import box_utils as tb
from dfq_tpu_torch.detection.device_nms import (
    decode_locations,
    decode_nms,
    decode_nms_batch,
    predict_on_device,
)
from dfq_tpu_torch.detection.predictor import Predictor
from dfq_tpu_torch.metrics import detection as tmet
from dfq_tpu_torch.models.ssd import SSDConfig

torch.set_num_threads(1)


def _random_problem(seed, n_priors=400, n_classes=6):
    """As ``tests/test_device_nms.py:20-33``."""
    rng = np.random.default_rng(seed)
    priors = np.stack(
        [rng.uniform(0.1, 0.9, n_priors), rng.uniform(0.1, 0.9, n_priors),
         rng.uniform(0.05, 0.3, n_priors), rng.uniform(0.05, 0.3, n_priors)],
        axis=1,
    ).astype(np.float32)
    loc = rng.normal(0, 1, (n_priors, 4)).astype(np.float32)
    logits = rng.normal(0, 2, (n_priors, n_classes)).astype(np.float32)
    conf = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return conf.astype(np.float32), loc, priors


def _boxes(seed, n=64):
    rng = np.random.default_rng(seed)
    lt = rng.uniform(0, 0.7, (n, 2))
    return np.concatenate([lt, lt + rng.uniform(0.01, 0.3, (n, 2))], 1).astype(np.float32)


def test_box_utils_equal():
    conf, loc, priors = _random_problem(0)
    for a, b in ((tb.convert_locations_to_boxes(loc, priors, 0.1, 0.2),
                  jb.convert_locations_to_boxes(loc, priors, 0.1, 0.2)),
                 (tb.convert_locations_to_boxes(loc[None], priors, 0.1, 0.2),
                  jb.convert_locations_to_boxes(loc[None], priors, 0.1, 0.2)),
                 (tb.center_form_to_corner_form(priors), jb.center_form_to_corner_form(priors)),
                 (tb.corner_form_to_center_form(priors), jb.corner_form_to_center_form(priors))):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the torch forms of the two conversions, as the device path uses them
    t = tb.center_form_to_corner_form(tb.convert_locations_to_boxes(
        torch.from_numpy(loc), torch.from_numpy(priors), 0.1, 0.2))
    np.testing.assert_allclose(t.numpy(), jb.center_form_to_corner_form(
        jb.convert_locations_to_boxes(loc, priors, 0.1, 0.2)), rtol=1e-6, atol=1e-7)
    b0, b1 = _boxes(1), _boxes(2)
    assert np.array_equal(tb.area_of(b0[:, :2], b0[:, 2:]), jb.area_of(b0[:, :2], b0[:, 2:]))
    assert np.array_equal(tb.iou_of(b0[:, None], b1[None]), jb.iou_of(b0[:, None], b1[None]))


@pytest.mark.parametrize("top_k", [-1, 5])
def test_nms_equal(top_k):
    rng = np.random.default_rng(3)
    bs = np.concatenate([_boxes(4, 300), rng.permutation(300)[:, None] / 300.0],
                        1).astype(np.float32)  # distinct scores
    for thr in (0.3, 0.5):
        assert np.array_equal(tb.hard_nms(bs, thr, top_k=top_k, candidate_size=100),
                              jb.hard_nms(bs, thr, top_k=top_k, candidate_size=100))
        assert np.array_equal(tb.nms(bs, None, iou_threshold=thr, top_k=top_k),
                              jb.nms(bs, None, iou_threshold=thr, top_k=top_k))
    assert np.array_equal(tb.soft_nms(bs, 0.2, top_k=top_k), jb.soft_nms(bs, 0.2, top_k=top_k))
    assert np.array_equal(tb.nms(bs, "soft", score_threshold=0.1, top_k=top_k),
                          jb.nms(bs, "soft", score_threshold=0.1, top_k=top_k))


def test_decode_matches_jax():
    conf, loc, priors = _random_problem(0)
    got = decode_locations(torch.from_numpy(loc), torch.from_numpy(priors), 0.1, 0.2)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_decode_locations(loc, priors, 0.1, 0.2)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("thr", [0.05, 0.3])
def test_device_nms_matches_jax(seed, thr):
    """Same keep-set in the same order as JAX's ``decode_nms``
    (the seeds x thresholds of ``tests/test_device_nms.py:67-95``)."""
    conf, loc, priors = _random_problem(seed)
    kw = dict(prob_threshold=thr, iou_threshold=0.45, candidate_size=200, top_k=10)
    b, s, v = (t.numpy() for t in decode_nms(torch.from_numpy(conf), torch.from_numpy(loc),
                                              torch.from_numpy(priors), **kw))
    jb_, js, jv = (np.asarray(t) for t in j_decode_nms(conf, loc, priors, **kw))
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_allclose(b, jb_, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(s, js)
    assert v.sum() > 0


def _host_keep(conf, loc, priors, thr, iou, top_k):
    boxes = tb.center_form_to_corner_form(tb.convert_locations_to_boxes(loc, priors, 0.1, 0.2))
    out = {}
    for c in range(1, conf.shape[1]):
        m = conf[:, c] > thr
        if m.any():
            bp = np.concatenate([boxes[m], conf[m, c, None]], 1).astype(np.float32)
            out[c] = tb.hard_nms(bp, iou, top_k=top_k, candidate_size=200)
    return out


def test_tied_scores_host_and_device_agree():
    """int8 confidences tie often: scores on a grid of 8 levels, so every
    class has many equal scores among overlapping boxes."""
    conf, loc, priors = _random_problem(5)
    conf = (np.round(conf * 8) / 8).astype(np.float32)
    ties = sum(len(col) - len(np.unique(col)) for col in conf[:, 1:].T)
    assert ties > 300
    kw = dict(prob_threshold=0.1, iou_threshold=0.45, candidate_size=200, top_k=20)
    b, s, v = (t.numpy() for t in decode_nms(torch.from_numpy(conf), torch.from_numpy(loc),
                                              torch.from_numpy(priors), **kw))
    host = _host_keep(conf, loc, priors, 0.1, 0.45, 20)
    for c in range(1, conf.shape[1]):
        n = int(v[c - 1].sum())
        ref = host.get(c, np.zeros((0, 5), np.float32))
        assert n == len(ref) and v[c - 1, :n].all(), c
        np.testing.assert_allclose(b[c - 1, :n], ref[:, :4], rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(s[c - 1, :n], ref[:, 4])


def test_decode_nms_batch_matches_per_image():
    confs, locs = [], []
    for seed in (10, 11, 12):
        c, l, priors = _random_problem(seed)
        confs.append(c)
        locs.append(l)
    kw = dict(prob_threshold=0.1, iou_threshold=0.45, candidate_size=200, top_k=8)
    b, s, v = decode_nms_batch(torch.from_numpy(np.stack(confs)),
                               torch.from_numpy(np.stack(locs)), torch.from_numpy(priors), **kw)
    assert b.shape == (3, 5, 8, 4) and s.shape == v.shape == (3, 5, 8)
    for i in range(3):
        bi, si, vi = decode_nms(torch.from_numpy(confs[i]), torch.from_numpy(locs[i]),
                                torch.from_numpy(priors), **kw)
        assert torch.equal(v[i], vi) and torch.equal(b[i], bi) and torch.equal(s[i], si)


def test_predict_on_device_contract():
    conf, loc, priors = _random_problem(4)
    boxes, labels, probs = predict_on_device(
        torch.from_numpy(conf), torch.from_numpy(loc), torch.from_numpy(priors), (375, 500),
        prob_threshold=0.05, iou_threshold=0.45, top_k=5)
    assert boxes.dtype == probs.dtype == np.float32 and labels.dtype == np.int32
    assert boxes.shape == (len(labels), 4) and len(labels) == len(probs) > 0
    assert boxes[:, 0].max() <= 500 * 1.5 and boxes[:, 1].max() <= 375 * 1.5
    assert set(labels) <= set(range(1, conf.shape[1]))
    assert list(labels) == sorted(labels)  # class by class
    empty = predict_on_device(torch.from_numpy(conf), torch.from_numpy(loc),
                              torch.from_numpy(priors), (375, 500), prob_threshold=0.999)
    assert [a.shape for a in empty] == [(0, 4), (0,), (0,)]


@pytest.mark.parametrize("shape", [(375, 500, 3), (300, 300, 3)])
def test_predictor_device_flag_matches_host(shape):
    cfg = SSDConfig()
    rng = np.random.default_rng(7)
    n = cfg.priors.shape[0]
    logits = rng.normal(0, 2, (n, 21)).astype(np.float32)
    conf = torch.from_numpy((np.exp(logits) / np.exp(logits).sum(-1, keepdims=True))
                            .astype(np.float32)[None])
    loc = torch.from_numpy(rng.normal(0, 1, (n, 4)).astype(np.float32)[None])
    img = np.zeros(shape, np.float32)
    host = Predictor(lambda x: (conf, loc), cfg).predict(img, top_k=10, prob_threshold=0.2)
    dev = Predictor(lambda x: (conf, loc), cfg, device_nms=True).predict(
        img, top_k=10, prob_threshold=0.2)
    assert len(host[1]) > 0
    # the same detections in the same order: class by class, each in pick order
    np.testing.assert_array_equal(host[1], dev[1])
    np.testing.assert_allclose(host[0], dev[0], rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(host[2], dev[2])


def test_preprocess_skips_resize_only_where_cv2_is_identity():
    import cv2

    cfg = SSDConfig()
    pred = Predictor(lambda x: None, cfg)
    img = np.random.default_rng(0).uniform(0, 255, (300, 300, 3)).astype(np.float32)
    want = (cv2.resize(img, (300, 300)) - np.float32(127.0)) / 128.0
    assert np.array_equal(pred.preprocess(img)[0], want)
    other = np.random.default_rng(1).integers(0, 255, (200, 250, 3)).astype(np.uint8)
    want = (cv2.resize(other.astype(np.float32), (300, 300)) - np.float32(127.0)) / 128.0
    assert np.array_equal(pred.preprocess(other)[0], want)


def test_average_precision_equal():
    rng = np.random.default_rng(0)
    for n in (1, 7, 50):
        tp = rng.integers(0, 2, n).astype(float)
        tp_c, fp_c = np.cumsum(tp), np.cumsum(1 - tp)
        precision = tp_c / np.maximum(tp_c + fp_c, 1e-12)
        recall = tp_c / max(tp.sum(), 1)
        assert tmet.compute_average_precision(precision.copy(), recall.copy()) == \
            jmet.compute_average_precision(precision.copy(), recall.copy())
        assert tmet.compute_voc2007_average_precision(precision, recall) == \
            jmet.compute_voc2007_average_precision(precision, recall)
