"""The port's training-side detection and segmentation modules against the
JAX package's, on the CPU: prior matching (``assign_priors``,
``convert_boxes_to_locations``, ``MatchPrior``) at SSD-Lite's 3000 priors,
the multibox loss and its hard-negative mask, and the SSD and
segmentation transform stacks under the same seed.

Tolerances: the host numpy functions and the transforms are equal (the
same operations in the same order, the same draws from Python's
``random``); ``multibox_loss`` within ``rtol=1e-5`` of JAX's (f32 sums in
other orders) with an equal mask, ties included.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dfq_tpu.detection import box_utils as jbox
from dfq_tpu.detection import losses as jlosses
from dfq_tpu.detection import transforms as jtr
from dfq_tpu.models import SSDConfig
from dfq_tpu_torch.detection import box_utils as tbox
from dfq_tpu_torch.detection import losses as tlosses
from dfq_tpu_torch.detection import transforms as ttr

torch.set_num_threads(1)
GT_BOXES = np.array([[0.1, 0.1, 0.4, 0.5], [0.5, 0.5, 0.9, 0.9]], np.float32)
GT_LABELS = np.array([3, 7])


@pytest.fixture(scope="module")
def cfg():
    return SSDConfig()


def test_assign_priors_and_locations_equal(cfg):
    corner = jbox.center_form_to_corner_form(cfg.priors)
    for thr in (0.5, 0.1):
        jb, jl = jbox.assign_priors(GT_BOXES, GT_LABELS, corner, thr)
        tb, tl = tbox.assign_priors(GT_BOXES, GT_LABELS, corner, thr)
        np.testing.assert_array_equal(tb, jb)
        np.testing.assert_array_equal(tl, jl)
    centers = jbox.corner_form_to_center_form(jb)
    np.testing.assert_array_equal(
        tbox.convert_boxes_to_locations(centers, cfg.priors, 0.1, 0.2),
        jbox.convert_boxes_to_locations(centers, cfg.priors, 0.1, 0.2))


def test_match_prior_equal(cfg):
    args = (cfg.priors, cfg.center_variance, cfg.size_variance, cfg.iou_threshold)
    jloc, jlab = jlosses.MatchPrior(*args)(GT_BOXES, GT_LABELS)
    tloc, tlab = tlosses.MatchPrior(*args)(GT_BOXES, GT_LABELS)
    assert tloc.shape == (3000, 4) and tloc.dtype == np.float32
    np.testing.assert_array_equal(tloc, jloc)
    np.testing.assert_array_equal(tlab, jlab)
    assert set(np.unique(tlab)) <= {0, 3, 7} and (tlab > 0).sum() >= 2


def _loss_inputs(cfg):
    """``tests/test_models_seg_det.py:376``'s inputs."""
    args = (cfg.priors, cfg.center_variance, cfg.size_variance, cfg.iou_threshold)
    locations, labels = jlosses.MatchPrior(*args)(GT_BOXES, GT_LABELS)
    rng = np.random.default_rng(0)
    conf = rng.normal(0, 1, (2, 3000, 21)).astype(np.float32)
    pred_loc = rng.normal(0, 1, (2, 3000, 4)).astype(np.float32)
    return conf, pred_loc, np.stack([labels, labels]), np.stack([locations, locations])


def _both(conf, pred_loc, labels, gt_loc):
    want = jlosses.multibox_loss(jnp.asarray(conf), jnp.asarray(pred_loc),
                                 jnp.asarray(labels), jnp.asarray(gt_loc))
    got = tlosses.multibox_loss(torch.from_numpy(conf), torch.from_numpy(pred_loc),
                                torch.from_numpy(labels), torch.from_numpy(gt_loc))
    return [float(v) for v in got], [float(v) for v in want]


def _masks(conf, labels):
    j_lp = np.asarray(jnp.asarray(conf) - jnp.log(jnp.sum(jnp.exp(conf), -1, keepdims=True)))
    jm = np.asarray(jlosses.hard_negative_mining(jnp.asarray(-j_lp[..., 0]),
                                                 jnp.asarray(labels), 3))
    tm = tlosses.hard_negative_mining(torch.from_numpy(-j_lp[..., 0]),
                                      torch.from_numpy(labels), 3).numpy()
    return tm, jm


def test_multibox_loss_matches_jax(cfg):
    conf, pred_loc, labels, gt_loc = _loss_inputs(cfg)
    got, want = _both(conf, pred_loc, labels, gt_loc)
    assert got[0] > 0 and got[1] > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    tm, jm = _masks(conf, labels)
    np.testing.assert_array_equal(tm, jm)


def test_multibox_loss_tied_negatives(cfg):
    """Every negative of an image with the same background loss: the mask
    keeps the first ``3 * positives`` in prior order, as JAX's stable
    argsort ranks them."""
    conf, pred_loc, labels, gt_loc = _loss_inputs(cfg)
    conf[0] = 0.0  # image 0: every prior's logits equal
    conf[1, :, 0] = np.round(conf[1, :, 0])  # image 1: many ties
    tm, jm = _masks(conf, labels)
    np.testing.assert_array_equal(tm, jm)
    neg = tm[0] & (labels[0] == 0)
    n_pos = int((labels[0] > 0).sum())
    assert neg.sum() == 3 * n_pos and np.flatnonzero(neg)[-1] < 3 * n_pos + n_pos
    got, want = _both(conf, pred_loc, labels, gt_loc)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_multibox_loss_gradient_finite(cfg):
    conf, pred_loc, labels, gt_loc = _loss_inputs(cfg)
    c = torch.from_numpy(conf).requires_grad_(True)
    p = torch.from_numpy(pred_loc).requires_grad_(True)
    l1, ce = tlosses.multibox_loss(c, p, torch.from_numpy(labels), torch.from_numpy(gt_loc))
    (l1 + ce).backward()
    assert torch.isfinite(c.grad).all() and torch.isfinite(p.grad).all()
    assert c.grad.abs().sum() > 0 and p.grad.abs().sum() > 0


def _det_image():
    rng = np.random.default_rng(1)
    img = rng.integers(0, 255, (240, 320, 3)).astype(np.float32)
    boxes = np.array([[20, 30, 200, 180], [50, 60, 120, 140]], np.float32)
    return img, boxes, np.array([3, 7])


@pytest.mark.parametrize("explicit_rng", [False, True])
def test_det_train_augmentation_equal(explicit_rng):
    """Five seeded draws of ``TrainAugmentation`` equal to JAX's, with the
    module's generator or an explicit ``random.Random``."""
    img, boxes, labels = _det_image()
    jaug = jtr.TrainAugmentation(size=300)
    for seed in range(5):
        random.seed(seed)
        want = jaug(img, boxes, labels)
        if explicit_rng:
            random.seed(1000)  # the module generator must not be drawn from
            got = ttr.TrainAugmentation(size=300, rng=random.Random(seed))(img, boxes, labels)
        else:
            random.seed(seed)
            got = ttr.TrainAugmentation(size=300)(img, boxes, labels)
        assert got[0].shape == (300, 300, 3) and got[1].shape[1] == 4
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_det_test_and_prediction_transform_equal():
    img, boxes, labels = _det_image()
    for a, b in zip(ttr.TestTransform(300)(img, boxes, labels),
                    jtr.TestTransform(300)(img, boxes, labels)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ttr.PredictionTransform(300)(img),
                                  jtr.PredictionTransform(300)(img))


@pytest.mark.parametrize("explicit_rng", [False, True])
def test_seg_transforms_equal(explicit_rng):
    """``tests/test_transforms.py``'s train and val stacks, equal to JAX's
    under the same seeds."""
    from PIL import Image

    from dfq_tpu.data import seg_transforms as jst
    from dfq_tpu_torch.data import seg_transforms as tst

    rng = np.random.default_rng(0)
    img = Image.fromarray(rng.integers(0, 255, (120, 160, 3), np.uint8))
    mask = Image.fromarray(rng.integers(0, 21, (120, 160), np.uint8))

    def train(mod, r=None):
        kw = {} if r is None else {"rng": r}
        return mod.Compose([mod.RandomHorizontalFlip(**kw),
                            mod.RandomScaleCrop(base_size=100, crop_size=97, **kw),
                            mod.RandomRotate(15, **kw), mod.RandomGaussianBlur(**kw),
                            mod.Normalize()])

    for seed in range(4):
        random.seed(seed)
        want = train(jst)({"image": img, "label": mask})
        if explicit_rng:
            got = train(tst, random.Random(seed))({"image": img, "label": mask})
        else:
            random.seed(seed)
            got = train(tst)({"image": img, "label": mask})
        assert got["image"].shape == (97, 97, 3) and got["image"].dtype == np.float32
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["label"], want["label"])
    for crop in (97, 129):
        want = jst.Compose([jst.FixScaleCrop(crop), jst.Normalize()])({"image": img,
                                                                       "label": mask})
        got = tst.Compose([tst.FixScaleCrop(crop), tst.Normalize()])({"image": img,
                                                                      "label": mask})
        np.testing.assert_array_equal(got["image"], want["image"])
        np.testing.assert_array_equal(got["label"], want["label"])
    sample = {"image": img, "label": mask}
    got, want = tst.FixedResize(64)(sample), jst.FixedResize(64)(sample)
    assert np.array_equal(np.asarray(got["image"]), np.asarray(want["image"]))
    assert np.array_equal(np.asarray(got["label"]), np.asarray(want["label"]))
