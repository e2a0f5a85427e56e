"""SSD prior-box generation and box geometry on the host (a copy of
``dfq_tpu/detection/box_utils.py``).

Behavioral contract: reference ``utils/detection/box_utils.py`` — prior
generation (``:12-80``), location<->box conversion with center/size
variances (``:83-116``), IoU (``:119-149``), target assignment
(``:152-179``), hard/soft NMS (``:219-292``). Vectorized numpy;
``convert_locations_to_boxes`` and ``center_form_to_corner_form`` also
take torch tensors. Hard NMS orders candidates by descending score and, on equal
scores, by ascending index (a stable sort), as
``dfq_tpu_torch.detection.device_nms`` does, so the two paths keep the
same boxes when int8 confidences tie.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SSDSpec:
    feature_map_size: int
    shrinkage: int
    box_min: float
    box_max: float
    aspect_ratios: Tuple[int, ...]


def generate_ssd_priors(
    specs: Sequence[SSDSpec], image_size: int, clamp: bool = True
) -> np.ndarray:
    """Center-form priors [cx, cy, w, h] relative to image size
    (reference ``box_utils.py:32-80``)."""
    priors: List[List[float]] = []
    for spec in specs:
        scale = image_size / spec.shrinkage
        for j, i in itertools.product(range(spec.feature_map_size), repeat=2):
            x_center = (i + 0.5) / scale
            y_center = (j + 0.5) / scale

            size = spec.box_min
            h = w = size / image_size
            priors.append([x_center, y_center, w, h])

            size = math.sqrt(spec.box_max * spec.box_min)
            h = w = size / image_size
            priors.append([x_center, y_center, w, h])

            size = spec.box_min
            h = w = size / image_size
            for ratio in spec.aspect_ratios:
                r = math.sqrt(ratio)
                priors.append([x_center, y_center, w * r, h / r])
                priors.append([x_center, y_center, w / r, h * r])

    out = np.array(priors, np.float32)
    if clamp:
        out = np.clip(out, 0.0, 1.0)
    return out


def _cat(parts):
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts, dim=-1)
    return np.concatenate(parts, axis=-1)


def convert_locations_to_boxes(locations, priors, center_variance, size_variance):
    """Regression outputs -> center-form boxes (``box_utils.py:83-106``).
    Works for numpy arrays and torch tensors."""
    if priors.ndim + 1 == locations.ndim:
        priors = priors[None, ...]
    exp = torch.exp if isinstance(locations, torch.Tensor) else np.exp
    return _cat([
        locations[..., :2] * center_variance * priors[..., 2:] + priors[..., :2],
        exp(locations[..., 2:] * size_variance) * priors[..., 2:],
    ])


def convert_boxes_to_locations(boxes, priors, center_variance, size_variance):
    """Center-form boxes -> regression targets (``box_utils.py:109-116``),
    host numpy."""
    if priors.ndim + 1 == boxes.ndim:
        priors = priors[None, ...]
    return np.concatenate(
        [
            (boxes[..., :2] - priors[..., :2]) / priors[..., 2:] / center_variance,
            np.log(boxes[..., 2:] / priors[..., 2:]) / size_variance,
        ],
        axis=-1,
    )


def center_form_to_corner_form(locations):
    return _cat([
        locations[..., :2] - locations[..., 2:] / 2,
        locations[..., :2] + locations[..., 2:] / 2,
    ])


def corner_form_to_center_form(boxes):
    return np.concatenate(
        [(boxes[..., :2] + boxes[..., 2:]) / 2, boxes[..., 2:] - boxes[..., :2]],
        axis=-1,
    )


def area_of(left_top, right_bottom):
    hw = np.clip(right_bottom - left_top, 0.0, None)
    return hw[..., 0] * hw[..., 1]


def iou_of(boxes0, boxes1, eps=1e-5):
    lt = np.maximum(boxes0[..., :2], boxes1[..., :2])
    rb = np.minimum(boxes0[..., 2:], boxes1[..., 2:])
    overlap = area_of(lt, rb)
    area0 = area_of(boxes0[..., :2], boxes0[..., 2:])
    area1 = area_of(boxes1[..., :2], boxes1[..., 2:])
    return overlap / (area0 + area1 - overlap + eps)


def hard_nms(box_scores, iou_threshold, top_k=-1, candidate_size=200):
    """Greedy NMS on [N, 5] corner-form boxes+score
    (``box_utils.py:219-249``); equal scores in index order."""
    scores = box_scores[:, -1]
    boxes = box_scores[:, :-1]
    picked: List[int] = []
    indexes = np.argsort(-scores, kind="stable")[:candidate_size]
    while len(indexes) > 0:
        current = indexes[0]
        picked.append(int(current))
        if 0 < top_k == len(picked) or len(indexes) == 1:
            break
        current_box = boxes[current]
        indexes = indexes[1:]
        ious = iou_of(boxes[indexes], current_box[None, :])
        indexes = indexes[ious <= iou_threshold]
    return box_scores[picked, :]


def soft_nms(box_scores, score_threshold, sigma=0.5, top_k=-1):
    """Soft-NMS (``box_utils.py:260-292``)."""
    box_scores = box_scores.copy()
    picked: List[np.ndarray] = []
    while box_scores.shape[0] > 0:
        idx = int(np.argmax(box_scores[:, 4]))
        cur = box_scores[idx].copy()
        picked.append(cur)
        if len(picked) == top_k > 0 or box_scores.shape[0] == 1:
            break
        box_scores[idx] = box_scores[-1]
        box_scores = box_scores[:-1]
        ious = iou_of(cur[None, :4], box_scores[:, :4])
        box_scores[:, 4] = box_scores[:, 4] * np.exp(-(ious * ious) / sigma)
        box_scores = box_scores[box_scores[:, 4] > score_threshold]
    if picked:
        return np.stack(picked)
    return np.zeros((0, 5), np.float32)


def nms(box_scores, nms_method=None, score_threshold=None, iou_threshold=None,
        sigma=0.5, top_k=-1, candidate_size=200):
    if nms_method == "soft":
        return soft_nms(box_scores, score_threshold, sigma, top_k)
    return hard_nms(box_scores, iou_threshold, top_k, candidate_size)


def assign_priors(gt_boxes, gt_labels, corner_form_priors, iou_threshold):
    """Target assignment, host numpy (training-time helper;
    ``box_utils.py:152-179``): each prior takes its best ground truth, each
    ground truth its best prior (whatever the IoU), and priors below
    ``iou_threshold`` the background label 0."""
    ious = iou_of(gt_boxes[None, :, :], corner_form_priors[:, None, :])
    best_target_per_prior = ious.max(axis=1)
    best_target_per_prior_index = ious.argmax(axis=1)
    best_prior_per_target_index = ious.argmax(axis=0)
    for target_index, prior_index in enumerate(best_prior_per_target_index):
        best_target_per_prior_index[prior_index] = target_index
    best_target_per_prior[best_prior_per_target_index] = 2.0
    labels = gt_labels[best_target_per_prior_index].copy()
    labels[best_target_per_prior < iou_threshold] = 0
    boxes = gt_boxes[best_target_per_prior_index]
    return boxes, labels
