"""Confusion-matrix segmentation metrics (a copy of
``dfq_tpu/metrics/segmentation.py``).

Behavioral contract: reference ``utils/metrics.py:4-50`` (``Evaluator``):
pixel accuracy, per-class accuracy, mIOU, and frequency-weighted IOU
from an accumulated num_class^2 confusion matrix.
"""

from __future__ import annotations

import numpy as np


class SegEvaluator:
    def __init__(self, num_class: int):
        self.num_class = num_class
        self.confusion_matrix = np.zeros((num_class, num_class), np.int64)

    def _generate_matrix(self, gt_image: np.ndarray, pre_image: np.ndarray):
        mask = (gt_image >= 0) & (gt_image < self.num_class)
        label = self.num_class * gt_image[mask].astype(np.int64) + pre_image[mask]
        count = np.bincount(label, minlength=self.num_class**2)
        return count.reshape(self.num_class, self.num_class)

    def add_batch(self, gt_image: np.ndarray, pre_image: np.ndarray) -> None:
        if gt_image.shape != pre_image.shape:
            raise ValueError(f"shapes differ: {gt_image.shape} vs {pre_image.shape}")
        self.confusion_matrix += self._generate_matrix(gt_image, pre_image)

    def pixel_accuracy(self) -> float:
        m = self.confusion_matrix
        return float(np.diag(m).sum() / m.sum())

    def pixel_accuracy_class(self) -> float:
        m = self.confusion_matrix
        acc = np.diag(m) / m.sum(axis=1)
        return float(np.nanmean(acc))

    def mean_iou(self) -> float:
        m = self.confusion_matrix
        iou = np.diag(m) / (m.sum(axis=1) + m.sum(axis=0) - np.diag(m))
        return float(np.nanmean(iou))

    def fw_iou(self) -> float:
        m = self.confusion_matrix
        freq = m.sum(axis=1) / m.sum()
        iou = np.diag(m) / (m.sum(axis=1) + m.sum(axis=0) - np.diag(m))
        return float((freq[freq > 0] * iou[freq > 0]).sum())

    def reset(self) -> None:
        self.confusion_matrix[:] = 0
