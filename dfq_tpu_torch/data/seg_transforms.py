"""Segmentation transforms (host, numpy/PIL; port of
``dfq_tpu/data/seg_transforms.py``).

Behavioral contract: reference
``dataset/segmentation/custom_transforms.py`` — the train/val transform
classes operating on ``{"image", "label"}`` sample dicts: Normalize,
RandomHorizontalFlip, RandomRotate, RandomGaussianBlur,
RandomScaleCrop (fill=254 on labels), FixScaleCrop, FixedResize.
Outputs NHWC float32 (no torch tensors). PIL is imported where it is
used.

The random transforms draw from Python's ``random`` in the JAX package's
order, so the same seed gives the same flip, rotation, blur and crop.
Each takes an optional ``rng`` (a ``random.Random``); by default the
module's generator is used, as in the JAX package.
"""

from __future__ import annotations

import random
from typing import Dict, Optional

import numpy as np

Sample = Dict[str, "object"]  # {"image": PIL.Image, "label": PIL.Image}


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

    def __call__(self, sample: Sample) -> Sample:
        for t in self.transforms:
            sample = t(sample)
        return sample


class Normalize:
    """(x/255 - mean)/std on the image; label to int array."""

    def __init__(self, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, sample: Sample) -> Sample:
        img = np.asarray(sample["image"], np.float32) / 255.0
        img = (img - self.mean) / self.std
        label = np.asarray(sample["label"], np.float32)
        return {"image": img, "label": label}


class RandomHorizontalFlip(_Random):
    def __init__(self, rng=None):
        self.rng = rng

    def __call__(self, sample: Sample) -> Sample:
        from PIL import Image

        if self.rand.random() < 0.5:
            return {
                "image": sample["image"].transpose(Image.FLIP_LEFT_RIGHT),
                "label": sample["label"].transpose(Image.FLIP_LEFT_RIGHT),
            }
        return sample


class RandomRotate(_Random):
    def __init__(self, degree: float, rng=None):
        self.degree, self.rng = degree, rng

    def __call__(self, sample: Sample) -> Sample:
        from PIL import Image

        deg = self.rand.uniform(-self.degree, self.degree)
        return {
            "image": sample["image"].rotate(deg, Image.BILINEAR),
            "label": sample["label"].rotate(deg, Image.NEAREST),
        }


class RandomGaussianBlur(_Random):
    def __init__(self, rng=None):
        self.rng = rng

    def __call__(self, sample: Sample) -> Sample:
        from PIL import ImageFilter

        if self.rand.random() < 0.5:
            return {
                "image": sample["image"].filter(
                    ImageFilter.GaussianBlur(radius=self.rand.random())
                ),
                "label": sample["label"],
            }
        return sample


class RandomScaleCrop(_Random):
    """Random scale in [0.5, 2.0] x base_size, pad (label fill=254),
    random crop (reference ``custom_transforms.py`` RandomScaleCrop)."""

    def __init__(self, base_size: int, crop_size: int, fill: int = 254, rng=None):
        self.base_size = base_size
        self.crop_size = crop_size
        self.fill = fill
        self.rng = rng

    def __call__(self, sample: Sample) -> Sample:
        from PIL import Image, ImageOps

        img, mask = sample["image"], sample["label"]
        short_size = self.rand.randint(
            int(self.base_size * 0.5), int(self.base_size * 2.0)
        )
        w, h = img.size
        if h > w:
            ow = short_size
            oh = int(1.0 * h * ow / w)
        else:
            oh = short_size
            ow = int(1.0 * w * oh / h)
        img = img.resize((ow, oh), Image.BILINEAR)
        mask = mask.resize((ow, oh), Image.NEAREST)
        if short_size < self.crop_size:
            padh = max(self.crop_size - oh, 0)
            padw = max(self.crop_size - ow, 0)
            img = ImageOps.expand(img, border=(0, 0, padw, padh), fill=0)
            mask = ImageOps.expand(mask, border=(0, 0, padw, padh), fill=self.fill)
        w, h = img.size
        x1 = self.rand.randint(0, w - self.crop_size)
        y1 = self.rand.randint(0, h - self.crop_size)
        box = (x1, y1, x1 + self.crop_size, y1 + self.crop_size)
        return {"image": img.crop(box), "label": mask.crop(box)}


class FixScaleCrop:
    """Scale short side then center crop (the val transform)."""

    def __init__(self, crop_size: int):
        self.crop_size = crop_size

    def __call__(self, sample: Sample) -> Sample:
        from dfq_tpu_torch.data.voc import fix_scale_crop

        img, mask = fix_scale_crop(sample["image"], sample["label"], self.crop_size)
        return {"image": img, "label": mask}


class FixedResize:
    def __init__(self, size: int):
        self.size = (size, size)

    def __call__(self, sample: Sample) -> Sample:
        from PIL import Image

        return {
            "image": sample["image"].resize(self.size, Image.BILINEAR),
            "label": sample["label"].resize(self.size, Image.NEAREST),
        }
