"""VOC detection average precision (a copy of
``dfq_tpu/metrics/detection.py``).

Behavioral contract: reference ``utils/detection/measurements.py``:
area-under-PR-curve AP (VOC2012 style, ``:4-21``) and 11-point
interpolated AP (VOC2007, ``:24-32``).
"""

from __future__ import annotations

import numpy as np


def compute_average_precision(precision: np.ndarray, recall: np.ndarray) -> float:
    """VOC2012-style area AP with precision envelope
    (``measurements.py:4-21``)."""
    precision = np.concatenate([[0.0], precision, [0.0]])
    recall = np.concatenate([[0.0], recall, [1.0]])
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = np.maximum(precision[i - 1], precision[i])
    changed = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(np.sum((recall[changed] - recall[changed - 1]) * precision[changed]))


def compute_voc2007_average_precision(
    precision: np.ndarray, recall: np.ndarray
) -> float:
    """11-point interpolated AP (``measurements.py:24-32``)."""
    ap = 0.0
    for t in np.arange(0.0, 1.1, 0.1):
        if np.sum(recall >= t) == 0:
            p = 0.0
        else:
            p = float(np.max(precision[recall >= t]))
        ap += p / 11.0
    return ap
