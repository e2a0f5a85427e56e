"""SSD inference predictor: preprocess -> forward -> decode -> NMS (port
of ``dfq_tpu/detection/predictor.py``).

Behavioral contract: reference ``modeling/detection/predictor.py:29-73``
— resize/normalize, forward, ``convert_locations_to_boxes`` + center->
corner (``:38-39``), per-class score threshold + NMS (``:46-66``),
rescale to pixel coordinates (``:70-73``). NMS runs on the host (numpy),
or with ``device_nms=True`` on the forward's device
(:mod:`dfq_tpu_torch.detection.device_nms`).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from dfq_tpu_torch.detection import box_utils


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


class Predictor:
    def __init__(
        self,
        forward_fn: Callable,  # (N,H,W,3) f32 numpy -> (conf softmaxed, loc)
        config,  # dfq_tpu_torch.models.ssd.SSDConfig (duck-typed)
        *,
        priors: Optional[np.ndarray] = None,
        iou_threshold: Optional[float] = None,
        candidate_size: int = 200,
        nms_method: Optional[str] = None,
        sigma: float = 0.5,
        filter_threshold: float = 0.01,
        device_nms: bool = False,
    ):
        self.forward_fn = forward_fn
        self.config = config
        self.priors = config.priors if priors is None else priors
        self.iou_threshold = (
            config.iou_threshold if iou_threshold is None else iou_threshold
        )
        self.candidate_size = candidate_size
        self.nms_method = nms_method
        self.sigma = sigma
        self.filter_threshold = filter_threshold
        # hard-NMS only: soft-NMS stays on the host
        self.device_nms = device_nms and nms_method != "soft"

    def preprocess(self, image: np.ndarray) -> np.ndarray:
        """HWC uint8/float RGB -> normalized NHWC f32 (reference
        ``data_preprocessing.py:51-60``: resize, subtract mean, /std). An
        image already ``image_size`` square is not resized (``cv2.resize``
        to its own size returns it unchanged), so cv2 is needed only for
        other sizes."""
        size = self.config.image_size
        img = image.astype(np.float32)
        if img.shape[:2] != (size, size):
            import cv2

            img = cv2.resize(img, (size, size))
        img = (img - np.asarray(self.config.image_mean, np.float32)) / float(
            self.config.image_std
        )
        return img[None, ...]

    def predict(
        self, image: np.ndarray, top_k: int = -1, prob_threshold: Optional[float] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (boxes[K,4] in pixels, labels[K], probs[K])."""
        height, width = image.shape[:2]
        x = self.preprocess(image)
        conf, loc = self.forward_fn(x)
        # `prob_threshold or self.filter_threshold` treats an explicit 0.0
        # as unset, as the reference predictor does (``predictor.py:46``);
        # both paths share it
        if self.device_nms:
            from dfq_tpu_torch.detection.device_nms import predict_on_device

            conf = torch.as_tensor(conf)
            return predict_on_device(
                conf[0],
                torch.as_tensor(loc, device=conf.device)[0],
                torch.as_tensor(self.priors, device=conf.device),
                (height, width),
                prob_threshold=float(prob_threshold or self.filter_threshold),
                iou_threshold=float(self.iou_threshold),
                candidate_size=self.candidate_size,
                top_k=int(top_k) if top_k > 0 else self.candidate_size,
                center_variance=float(self.config.center_variance),
                size_variance=float(self.config.size_variance),
            )
        conf = _np(conf)[0]
        loc = _np(loc)[0]

        boxes = box_utils.convert_locations_to_boxes(
            loc, self.priors, self.config.center_variance, self.config.size_variance
        )
        boxes = box_utils.center_form_to_corner_form(boxes)

        prob_threshold = prob_threshold or self.filter_threshold
        picked_box_probs = []
        picked_labels = []
        for class_index in range(1, conf.shape[1]):
            probs = conf[:, class_index]
            mask = probs > prob_threshold
            probs_m = probs[mask]
            if probs_m.shape[0] == 0:
                continue
            subset_boxes = boxes[mask, :]
            box_probs = np.concatenate(
                [subset_boxes, probs_m[:, None]], axis=1
            ).astype(np.float32)
            box_probs = box_utils.nms(
                box_probs,
                self.nms_method,
                score_threshold=prob_threshold,
                iou_threshold=self.iou_threshold,
                sigma=self.sigma,
                top_k=top_k,
                candidate_size=self.candidate_size,
            )
            picked_box_probs.append(box_probs)
            picked_labels.extend([class_index] * box_probs.shape[0])
        if not picked_box_probs:
            return (
                np.zeros((0, 4), np.float32),
                np.zeros((0,), np.int32),
                np.zeros((0,), np.float32),
            )
        picked = np.concatenate(picked_box_probs)
        picked[:, 0] *= width
        picked[:, 1] *= height
        picked[:, 2] *= width
        picked[:, 3] *= height
        return picked[:, :4], np.asarray(picked_labels, np.int32), picked[:, 4]
