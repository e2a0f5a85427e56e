"""SSD data transforms (host, numpy; port of
``dfq_tpu/detection/transforms.py``).

Behavioral contract: reference
``modeling/detection/transforms/transforms.py`` (the SSD augmentation
stack) and ``data_preprocessing.py`` (TrainAugmentation /
TestTransform / PredictionTransform). Images flow as HWC float32 RGB;
boxes as corner-form pixel coordinates until ToPercentCoords. ``cv2`` is
imported where it is used.

The random transforms draw from Python's ``random`` in the JAX package's
order, so the same seed gives the same crop, flip and jitter. Each takes
an optional ``rng`` (a ``random.Random``); by default the module's
generator is used, as in the JAX package.
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np

from dfq_tpu_torch.detection import box_utils


class _Random:
    """A transform that draws from ``rng`` (Python's ``random`` module's
    generator when None)."""

    rng: Optional[random.Random] = None

    @property
    def rand(self):
        return random if self.rng is None else self.rng


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, img, boxes=None, labels=None):
        for t in self.transforms:
            img, boxes, labels = t(img, boxes, labels)
        return img, boxes, labels


class ConvertFromInts:
    def __call__(self, image, boxes=None, labels=None):
        return image.astype(np.float32), boxes, labels


class SubtractMeans:
    def __init__(self, mean):
        self.mean = np.asarray(mean, np.float32)

    def __call__(self, image, boxes=None, labels=None):
        return image.astype(np.float32) - self.mean, boxes, labels


class Resize:
    def __init__(self, size: int = 300):
        self.size = size

    def __call__(self, image, boxes=None, labels=None):
        import cv2

        return cv2.resize(image, (self.size, self.size)), boxes, labels


class ToPercentCoords:
    def __call__(self, image, boxes=None, labels=None):
        if boxes is not None:
            h, w = image.shape[:2]
            boxes = boxes.astype(np.float32).copy()
            boxes[:, 0] /= w
            boxes[:, 2] /= w
            boxes[:, 1] /= h
            boxes[:, 3] /= h
        return image, boxes, labels


class RandomSaturation(_Random):
    def __init__(self, lower=0.5, upper=1.5, rng=None):
        self.lower, self.upper, self.rng = lower, upper, rng

    def __call__(self, image, boxes=None, labels=None):
        if self.rand.randint(0, 1):
            image = image.copy()
            image[:, :, 1] *= self.rand.uniform(self.lower, self.upper)
        return image, boxes, labels


class RandomHue(_Random):
    def __init__(self, delta=18.0, rng=None):
        self.delta, self.rng = delta, rng

    def __call__(self, image, boxes=None, labels=None):
        if self.rand.randint(0, 1):
            image = image.copy()
            image[:, :, 0] += self.rand.uniform(-self.delta, self.delta)
            image[:, :, 0][image[:, :, 0] > 360.0] -= 360.0
            image[:, :, 0][image[:, :, 0] < 0.0] += 360.0
        return image, boxes, labels


class RandomContrast(_Random):
    def __init__(self, lower=0.5, upper=1.5, rng=None):
        self.lower, self.upper, self.rng = lower, upper, rng

    def __call__(self, image, boxes=None, labels=None):
        if self.rand.randint(0, 1):
            image = image * self.rand.uniform(self.lower, self.upper)
        return image, boxes, labels


class RandomBrightness(_Random):
    def __init__(self, delta=32.0, rng=None):
        self.delta, self.rng = delta, rng

    def __call__(self, image, boxes=None, labels=None):
        if self.rand.randint(0, 1):
            image = image + self.rand.uniform(-self.delta, self.delta)
        return image, boxes, labels


class RandomLightingNoise(_Random):
    """Random channel permutation (reference RandomLightingNoise)."""

    PERMS = ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0))

    def __init__(self, rng=None):
        self.rng = rng

    def __call__(self, image, boxes=None, labels=None):
        if self.rand.randint(0, 1):
            image = image[:, :, self.rand.choice(self.PERMS)]
        return image, boxes, labels


class ConvertColor:
    def __init__(self, current="RGB", transform="HSV"):
        self.current, self.transform = current, transform

    def __call__(self, image, boxes=None, labels=None):
        import cv2

        if self.current == "RGB" and self.transform == "HSV":
            image = cv2.cvtColor(image, cv2.COLOR_RGB2HSV)
        elif self.current == "HSV" and self.transform == "RGB":
            image = cv2.cvtColor(image, cv2.COLOR_HSV2RGB)
        else:
            raise NotImplementedError
        return image, boxes, labels


class PhotometricDistort(_Random):
    """Brightness + (contrast/saturation/hue order coin-flip) + lighting
    noise (reference PhotometricDistort)."""

    def __init__(self, rng=None):
        self.rng = rng
        self.pd = [
            RandomContrast(rng=rng),
            ConvertColor(transform="HSV"),
            RandomSaturation(rng=rng),
            RandomHue(rng=rng),
            ConvertColor(current="HSV", transform="RGB"),
            RandomContrast(rng=rng),
        ]
        self.rand_brightness = RandomBrightness(rng=rng)
        self.rand_light_noise = RandomLightingNoise(rng=rng)

    def __call__(self, image, boxes, labels):
        im = image.copy()
        im, boxes, labels = self.rand_brightness(im, boxes, labels)
        if self.rand.randint(0, 1):
            distort = Compose(self.pd[:-1])
        else:
            distort = Compose(self.pd[1:])
        im, boxes, labels = distort(im, boxes, labels)
        return self.rand_light_noise(im, boxes, labels)


class Expand(_Random):
    """Place the image in a larger mean-filled canvas (zoom out)."""

    def __init__(self, mean, rng=None):
        self.mean, self.rng = mean, rng

    def __call__(self, image, boxes, labels):
        if self.rand.randint(0, 1):
            return image, boxes, labels
        h, w, c = image.shape
        ratio = self.rand.uniform(1, 4)
        left = self.rand.uniform(0, w * ratio - w)
        top = self.rand.uniform(0, h * ratio - h)
        expand = np.zeros((int(h * ratio), int(w * ratio), c), image.dtype)
        expand[:, :, :] = self.mean
        expand[int(top) : int(top) + h, int(left) : int(left) + w] = image
        boxes = boxes.copy()
        boxes[:, :2] += (int(left), int(top))
        boxes[:, 2:] += (int(left), int(top))
        return expand, boxes, labels


class RandomSampleCrop(_Random):
    """IoU-constrained random crop (reference RandomSampleCrop)."""

    SAMPLE_OPTIONS = (None, (0.1, None), (0.3, None), (0.7, None), (0.9, None),
                      (None, None))

    def __init__(self, rng=None):
        self.rng = rng

    def __call__(self, image, boxes=None, labels=None):
        h, w, _ = image.shape
        while True:
            mode = self.rand.choice(self.SAMPLE_OPTIONS)
            if mode is None:
                return image, boxes, labels
            min_iou, max_iou = mode
            min_iou = -np.inf if min_iou is None else min_iou
            max_iou = np.inf if max_iou is None else max_iou
            for _ in range(50):
                cw = self.rand.uniform(0.3 * w, w)
                ch = self.rand.uniform(0.3 * h, h)
                if ch / cw < 0.5 or ch / cw > 2:
                    continue
                left = self.rand.uniform(0, w - cw)
                top = self.rand.uniform(0, h - ch)
                rect = np.array(
                    [int(left), int(top), int(left + cw), int(top + ch)]
                )
                overlap = box_utils.iou_of(
                    boxes, rect[None, :].astype(np.float32)
                )
                if overlap.max() < min_iou or overlap.min() > max_iou:
                    continue
                centers = (boxes[:, :2] + boxes[:, 2:]) / 2.0
                m1 = (rect[0] < centers[:, 0]) & (rect[1] < centers[:, 1])
                m2 = (rect[2] > centers[:, 0]) & (rect[3] > centers[:, 1])
                mask = m1 & m2
                if not mask.any():
                    continue
                current = image[rect[1]:rect[3], rect[0]:rect[2], :]
                cur_boxes = boxes[mask].copy()
                cur_labels = labels[mask]
                cur_boxes[:, :2] = np.maximum(cur_boxes[:, :2], rect[:2])
                cur_boxes[:, :2] -= rect[:2]
                cur_boxes[:, 2:] = np.minimum(cur_boxes[:, 2:], rect[2:])
                cur_boxes[:, 2:] -= rect[:2]
                return current, cur_boxes, cur_labels


class RandomMirror(_Random):
    def __init__(self, rng=None):
        self.rng = rng

    def __call__(self, image, boxes, classes):
        _, w, _ = image.shape
        if self.rand.randint(0, 1):
            image = image[:, ::-1]
            boxes = boxes.copy()
            boxes[:, 0::2] = w - boxes[:, 2::-2]
        return image, boxes, classes


class TrainAugmentation:
    """Full SSD train pipeline (reference data_preprocessing.py:5-31)."""

    def __init__(self, size: int, mean=(127, 127, 127), std: float = 128.0, rng=None):
        self.augment = Compose(
            [
                ConvertFromInts(),
                PhotometricDistort(rng=rng),
                Expand(mean, rng=rng),
                RandomSampleCrop(rng=rng),
                RandomMirror(rng=rng),
                ToPercentCoords(),
                Resize(size),
                SubtractMeans(mean),
                lambda img, boxes=None, labels=None: (img / std, boxes, labels),
            ]
        )

    def __call__(self, img, boxes, labels):
        return self.augment(img, boxes, labels)


class TestTransform:
    def __init__(self, size: int, mean=(127, 127, 127), std: float = 128.0):
        self.transform = Compose(
            [
                ToPercentCoords(),
                Resize(size),
                SubtractMeans(mean),
                lambda img, boxes=None, labels=None: (img / std, boxes, labels),
            ]
        )

    def __call__(self, image, boxes, labels):
        return self.transform(image, boxes, labels)


class PredictionTransform:
    def __init__(self, size: int, mean=(127, 127, 127), std: float = 128.0):
        self.transform = Compose(
            [
                Resize(size),
                SubtractMeans(mean),
                lambda img, boxes=None, labels=None: (img / std, boxes, labels),
            ]
        )

    def __call__(self, image):
        image, _, _ = self.transform(image)
        return image
