"""Pascal VOC datasets: segmentation and detection (host side; a copy of
``dfq_tpu/data/voc.py``). PIL and cv2 are imported where an image is read.

Behavioral contracts:
- segmentation: reference ``dataset/segmentation/pascal.py`` — JPEGImages
  + SegmentationClass pairs from ImageSets/Segmentation/<split>.txt; the
  val transform is FixScaleCrop(513) + Normalize(ImageNet mean/std)
  (``:104-111``, ``custom_transforms.py``).
- detection: reference ``dataset/detection/voc_dataset.py`` — XML
  annotation parsing with Matlab 1-based -> 0-based correction
  (``:105-109``), BACKGROUND prepended as class 0 (``:40-56``).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Iterator, List, Tuple

import numpy as np

SEG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
SEG_STD = np.array([0.229, 0.224, 0.225], np.float32)

VOC_CLASS_NAMES = (
    "BACKGROUND",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def fix_scale_crop(img, target, crop_size: int):
    """Scale short side to crop_size then center-crop (reference
    ``custom_transforms.py`` FixScaleCrop — the val-time transform)."""
    from PIL import Image

    w, h = img.size
    if w > h:
        oh = crop_size
        ow = int(w * oh / h)
    else:
        ow = crop_size
        oh = int(h * ow / w)
    img = img.resize((ow, oh), Image.BILINEAR)
    target = target.resize((ow, oh), Image.NEAREST)
    x1 = int(round((ow - crop_size) / 2.0))
    y1 = int(round((oh - crop_size) / 2.0))
    box = (x1, y1, x1 + crop_size, y1 + crop_size)
    return img.crop(box), target.crop(box)


class VOCSegmentation:
    NUM_CLASSES = 21

    def __init__(self, base_dir: str, split: str = "val", crop_size: int = 513):
        self.crop_size = crop_size
        image_dir = os.path.join(base_dir, "JPEGImages")
        cat_dir = os.path.join(base_dir, "SegmentationClass")
        split_file = os.path.join(base_dir, "ImageSets", "Segmentation", split + ".txt")
        with open(split_file) as f:
            ids = f.read().splitlines()
        self.samples: List[Tuple[str, str]] = [
            (os.path.join(image_dir, i + ".jpg"), os.path.join(cat_dir, i + ".png"))
            for i in ids
        ]

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        from PIL import Image

        img_path, cat_path = self.samples[idx]
        img = Image.open(img_path).convert("RGB")
        target = Image.open(cat_path)
        img, target = fix_scale_crop(img, target, self.crop_size)
        x = np.asarray(img, np.float32) / 255.0
        x = (x - SEG_MEAN) / SEG_STD  # HWC
        y = np.asarray(target, np.int32)  # 255 = void
        return x, y

    def batches(self, batch_size: int = 4) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for i in range(0, len(self), batch_size):
            items = [self[j] for j in range(i, min(i + batch_size, len(self)))]
            yield (
                np.stack([it[0] for it in items]),
                np.stack([it[1] for it in items]),
            )


class VOCDetection:
    def __init__(self, root: str, split_file: str = "test", keep_difficult: bool = True):
        self.root = root
        path = os.path.join(root, "ImageSets", "Main", split_file + ".txt")
        with open(path) as f:
            self.ids = [line.rstrip() for line in f if line.strip()]
        self.keep_difficult = keep_difficult
        self.class_names = VOC_CLASS_NAMES
        self.class_dict = {n: i for i, n in enumerate(self.class_names)}

    def __len__(self) -> int:
        return len(self.ids)

    def get_annotation(self, idx: int):
        image_id = self.ids[idx]
        ann = os.path.join(self.root, "Annotations", image_id + ".xml")
        objects = ET.parse(ann).findall("object")
        boxes, labels, is_difficult = [], [], []
        for obj in objects:
            class_name = obj.find("name").text.lower().strip()
            if class_name not in self.class_dict:
                continue
            bbox = obj.find("bndbox")
            # Matlab 1-based -> 0-based (voc_dataset.py:105-109)
            boxes.append(
                [
                    float(bbox.find("xmin").text) - 1,
                    float(bbox.find("ymin").text) - 1,
                    float(bbox.find("xmax").text) - 1,
                    float(bbox.find("ymax").text) - 1,
                ]
            )
            labels.append(self.class_dict[class_name])
            d = obj.find("difficult").text
            is_difficult.append(int(d) if d else 0)
        return (
            image_id,
            (
                np.array(boxes, np.float32).reshape(-1, 4),
                np.array(labels, np.int64),
                np.array(is_difficult, np.uint8),
            ),
        )

    def get_image(self, idx: int) -> np.ndarray:
        import cv2

        path = os.path.join(self.root, "JPEGImages", self.ids[idx] + ".jpg")
        image = cv2.imread(path)
        return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
