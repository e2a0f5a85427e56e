"""ImageNet-folder evaluation pipeline (host side; a copy of
``dfq_tpu/data/imagenet.py``).

Replaces the reference's torchvision ImageFolder + DataLoader (its
``main_cls.py:46-54``): directory-per-class layout,
resize-256 / center-crop-224 / normalize preprocessing, batches emitted
NHWC float32 with overlap-friendly prefetch via a background thread.
"""

from __future__ import annotations

import concurrent.futures as futures
import os
from typing import Iterator, List, Tuple

import numpy as np

MEAN = np.array([0.485, 0.456, 0.406], np.float32)
STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_image(path: str, resize: int = 256, crop: int = 224) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    w, h = img.size
    scale = resize / min(w, h)
    img = img.resize((round(w * scale), round(h * scale)), Image.BILINEAR)
    w, h = img.size
    left = (w - crop) // 2
    top = (h - crop) // 2
    img = img.crop((left, top, left + crop, top + crop))
    x = np.asarray(img, np.float32) / 255.0
    return (x - MEAN) / STD  # HWC


def list_val_set(root: str) -> List[Tuple[str, int]]:
    """Directory-per-class layout; classes sorted by folder name (the
    torchvision ImageFolder convention the reference relies on)."""
    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    samples = []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for fname in sorted(os.listdir(cdir)):
            samples.append((os.path.join(cdir, fname), idx))
    return samples


def imagenet_batches(
    root: str,
    batch_size: int = 256,
    limit: int | None = None,
    num_workers: int = 16,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (images NHWC f32, labels i32); last partial batch dropped
    only if smaller than 1."""
    samples = list_val_set(root)
    if limit:
        samples = samples[:limit]
    with futures.ThreadPoolExecutor(num_workers) as pool:
        for i in range(0, len(samples), batch_size):
            chunk = samples[i : i + batch_size]
            imgs = list(pool.map(lambda s: load_image(s[0]), chunk))
            labels = np.array([s[1] for s in chunk], np.int32)
            yield np.stack(imgs), labels
