"""SSD training utilities: prior matching and the multibox loss (port of
``dfq_tpu/detection/losses.py``).

Behavioral contracts: reference ``modeling/detection/ssd.py:142-159``
(``MatchPrior``) and ``modeling/detection/nn/multibox_loss.py``
(hard-negative-mined cross entropy + smooth-L1 on positives). The
reference ships these but never trains. :class:`MatchPrior` is host
numpy; :func:`hard_negative_mining` and :func:`multibox_loss` run on
tensors on any device and are differentiable by autograd.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from dfq_tpu_torch.detection import box_utils


class MatchPrior:
    """Ground truth -> per-prior regression targets and labels (host)."""

    def __init__(self, center_form_priors, center_variance, size_variance, iou_threshold):
        self.center_form_priors = np.asarray(center_form_priors, np.float32)
        self.corner_form_priors = box_utils.center_form_to_corner_form(self.center_form_priors)
        self.center_variance = center_variance
        self.size_variance = size_variance
        self.iou_threshold = iou_threshold

    def __call__(self, gt_boxes: np.ndarray, gt_labels: np.ndarray):
        boxes, labels = box_utils.assign_priors(
            np.asarray(gt_boxes, np.float32), np.asarray(gt_labels),
            self.corner_form_priors, self.iou_threshold)
        boxes = box_utils.corner_form_to_center_form(boxes)
        locations = box_utils.convert_boxes_to_locations(
            boxes, self.center_form_priors, self.center_variance, self.size_variance)
        return locations.astype(np.float32), labels


def hard_negative_mining(loss: torch.Tensor, labels: torch.Tensor,
                         neg_pos_ratio: int) -> torch.Tensor:
    """Keep all positives and, per image, the ``neg_pos_ratio * positives``
    negatives of largest ``loss`` (reference ``box_utils.py:182-204``).
    The ranks come from two stable sorts, as JAX's ``argsort`` makes them,
    so negatives of equal loss rank in prior order and the mask is JAX's."""
    pos_mask = labels > 0
    num_neg = pos_mask.sum(dim=1, keepdim=True) * neg_pos_ratio
    loss = torch.where(pos_mask, torch.full_like(loss, -torch.inf), loss)
    order = torch.sort(-loss, dim=1, stable=True).indices
    ranks = torch.sort(order, dim=1, stable=True).indices
    return pos_mask | (ranks < num_neg)


def multibox_loss(
    confidence: torch.Tensor,  # [N, P, C] raw logits
    predicted_locations: torch.Tensor,  # [N, P, 4]
    labels: torch.Tensor,  # [N, P] int
    gt_locations: torch.Tensor,  # [N, P, 4]
    neg_pos_ratio: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(smooth_l1_loss, classification_loss)``, both normalized
    by the positive count (reference ``multibox_loss.py``)."""
    labels = labels.long()
    log_probs = torch.log_softmax(confidence, dim=2)
    with torch.no_grad():  # the mask selects terms; no gradient flows through it
        mask = hard_negative_mining(-log_probs[..., 0], labels, neg_pos_ratio)
    ce = -torch.gather(log_probs, 2, labels[..., None])[..., 0]
    classification_loss = torch.where(mask, ce, torch.zeros_like(ce)).sum()

    pos_mask = labels > 0
    diff = predicted_locations - gt_locations
    abs_diff = diff.abs()
    smooth_l1 = torch.where(abs_diff < 1.0, 0.5 * diff**2, abs_diff - 0.5)
    smooth_l1_loss = torch.where(pos_mask[..., None], smooth_l1, torch.zeros_like(smooth_l1)).sum()

    num_pos = pos_mask.sum().clamp(min=1)
    return smooth_l1_loss / num_pos, classification_loss / num_pos
