"""SSD post-process on the tensors' device: box decode + per-class greedy
hard-NMS (port of ``dfq_tpu/detection/device_nms.py``).

The reference leaves decode and NMS on the host
(``modeling/detection/predictor.py:38-66``, a Python loop per class).
Here the same greedy hard-NMS runs in torch wherever ``conf`` lies, with
fixed shapes, batched over images and classes at once:

- decode: ``convert_locations_to_boxes`` + center->corner (the formulas
  of ``box_utils.py:83-116``);
- per (image, class): the ``candidate_size`` highest scores above the
  threshold, by a stable descending sort (equal scores in prior order,
  as ``lax.top_k`` and the host path's stable ``argsort``), then a pick
  loop: each step takes the first candidate still alive, which is the
  greedy pick since candidates are score-sorted, and suppresses its
  overlaps. ``min(top_k, candidate_size)`` steps at most; the loop stops
  early once no candidate of any row is alive, which changes no output.
  Each step first asks the device whether any candidate is alive, a host
  sync: :data:`COUNTS` sums them, with the calls and the early stops;
- output: fixed-shape ``(C-1, top_k)`` boxes / scores / valid per image.

While a ``torch.profiler`` runs, a call opens the range
``device_nms/decode_nms_batch`` (a FUNCTION-scope range, as the fused
engine's: it leaves a caller's ``record_function`` its device
annotation).

Not a kernel: a few dozen small torch ops a step. Exactness against the
host path and against the JAX package: ``tests/test_torch_detection.py``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast as _Range
from torch.autograd import profiler as _autograd_profiler

SPAN = "device_nms/decode_nms_batch"
# calls of decode_nms_batch, host syncs (one per pick step's alive check)
# and calls whose loop stopped early; serving threads share them
COUNTS = {"calls": 0, "host_syncs": 0, "early_stops": 0}
_COUNTS_LOCK = threading.Lock()


def _count(key: str) -> None:
    with _COUNTS_LOCK:
        COUNTS[key] += 1


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
        _count("host_syncs")
        if not bool(alive.any()):
            _count("early_stops")
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
    _count("calls")
    with _Range(SPAN) if _autograd_profiler._is_profiler_enabled else contextlib.nullcontext():
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


def decode_nms(conf, loc, priors, **kw):
    """Single image: ``conf [P, C]``, ``loc [P, 4]`` ->
    ``(boxes[C-1, top_k, 4], scores[C-1, top_k], valid[C-1, top_k])``."""
    conf = torch.as_tensor(conf)
    b, s, v = decode_nms_batch(conf[None], torch.as_tensor(loc, device=conf.device)[None],
                               priors, **kw)
    return b[0], s[0], v[0]


def predict_on_device(conf, loc, priors, image_size_hw, **kw):
    """Fetch-and-unpack wrapper with ``Predictor.predict``'s return
    contract: ``(boxes[K, 4] in pixels, labels[K], probs[K])``, class by
    class, each in pick order."""
    b, s, v = decode_nms(conf, loc, priors, **kw)
    b, s, v = b.cpu().numpy(), s.cpu().numpy(), v.cpu().numpy()
    height, width = image_size_hw
    cls, k = np.nonzero(v)
    if len(cls) == 0:
        return (
            np.zeros((0, 4), np.float32),
            np.zeros((0,), np.int32),
            np.zeros((0,), np.float32),
        )
    scale = np.asarray([width, height, width, height])
    return (
        (b[cls, k] * scale).astype(np.float32),
        (cls + 1).astype(np.int32),
        s[cls, k].astype(np.float32),
    )
