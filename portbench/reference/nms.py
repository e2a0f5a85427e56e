"""SSD decode and per-class greedy hard-NMS in plain ``torch``: a frozen copy
of ``dfq_tpu_torch/detection/device_nms.py`` (``decode_nms_batch`` and what
it calls) as it stood when the benchmark was defined.

The benchmark runs it on the program's own class scores and box
regressions, on the same device and in the same float32 operations, so
its picks must equal the program's exactly; the scores and regressions
themselves are held against the float64 reference.
"""

from __future__ import annotations

from typing import Tuple

import torch


def decode_locations(loc, priors, center_variance: float, size_variance: float):
    """Regression outputs -> corner-form boxes (``box_utils.py:83-116``)."""
    centers = loc[..., :2] * center_variance * priors[..., 2:] + priors[..., :2]
    sizes = torch.exp(loc[..., 2:] * size_variance) * priors[..., 2:]
    return torch.cat([centers - sizes / 2.0, centers + sizes / 2.0], dim=-1)


def _areas(boxes: torch.Tensor) -> torch.Tensor:
    wh = torch.clamp(boxes[..., 2:] - boxes[..., :2], min=0.0)
    return wh[..., 0] * wh[..., 1]


def _nms_rows(scores, boxes, prob_threshold: float, iou_threshold: float,
              candidate_size: int, top_k: int):
    """Greedy hard-NMS for every row at once. ``scores``: [R, P] (one row
    per image and class), ``boxes``: [R, P, 4]. Returns
    ``(boxes[R, top_k, 4], scores[R, top_k], valid[R, top_k])``."""
    R, P = scores.shape
    masked = torch.where(scores > prob_threshold, scores, torch.zeros_like(scores))
    order = torch.sort(masked, dim=-1, descending=True, stable=True).indices
    cand_idx = order[:, :min(candidate_size, P)]
    cand_scores = torch.gather(masked, 1, cand_idx)
    cand_boxes = torch.gather(boxes, 1, cand_idx[..., None].expand(-1, -1, 4))
    cand_area = _areas(cand_boxes)
    alive = cand_scores > prob_threshold
    idxs = torch.zeros((R, top_k), dtype=torch.long, device=scores.device)
    valid = torch.zeros((R, top_k), dtype=torch.bool, device=scores.device)
    rows = torch.arange(R, device=scores.device)
    for t in range(min(top_k, candidate_size)):
        if not bool(alive.any()):
            break
        first = torch.argmax(alive.to(torch.uint8), dim=-1)  # first alive; 0 if none
        take = alive[rows, first]
        idxs[:, t] = first
        valid[:, t] = take
        box = cand_boxes[rows, first]  # [R, 4]
        lt = torch.maximum(box[:, None, :2], cand_boxes[..., :2])
        rb = torch.minimum(box[:, None, 2:], cand_boxes[..., 2:])
        wh = torch.clamp(rb - lt, min=0.0)
        inter = wh[..., 0] * wh[..., 1]
        iou = inter / (_areas(box)[:, None] + cand_area - inter + 1e-5)
        alive = alive & ~(take[:, None] & (iou > iou_threshold))
    out_boxes = torch.gather(cand_boxes, 1, idxs[..., None].expand(-1, -1, 4))
    out_scores = torch.gather(cand_scores, 1, idxs)
    out_boxes = torch.where(valid[..., None], out_boxes, torch.zeros_like(out_boxes))
    out_scores = torch.where(valid, out_scores, torch.zeros_like(out_scores))
    return out_boxes, out_scores, valid


def decode_nms_batch(
    conf,  # [B, P, C] softmaxed
    loc,  # [B, P, 4]
    priors,  # [P, 4] center-form
    *,
    prob_threshold: float = 0.01,
    iou_threshold: float = 0.45,
    candidate_size: int = 200,
    top_k: int = 10,
    center_variance: float = 0.1,
    size_variance: float = 0.2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched post-process on ``conf``'s device: ``(boxes[B, C-1, top_k, 4],
    scores[B, C-1, top_k], valid[B, C-1, top_k])``; class 0 (background)
    is skipped, so row c is class c+1."""
    conf = torch.as_tensor(conf)
    loc = torch.as_tensor(loc, device=conf.device)
    priors = torch.as_tensor(priors, device=conf.device)
    B, P, C = conf.shape
    boxes = decode_locations(loc, priors, center_variance, size_variance)  # [B, P, 4]
    scores = conf[..., 1:].transpose(1, 2).reshape(B * (C - 1), P)
    rows_boxes = boxes[:, None].expand(B, C - 1, P, 4).reshape(B * (C - 1), P, 4)
    b, s, v = _nms_rows(scores, rows_boxes, prob_threshold, iou_threshold,
                        candidate_size, top_k)
    return (b.reshape(B, C - 1, top_k, 4), s.reshape(B, C - 1, top_k),
            v.reshape(B, C - 1, top_k))
