"""Open Images detection dataset, annotation-CSV layout (a copy of
``dfq_tpu/data/open_images.py``; host only).

Behavioral contract: reference ``dataset/detection/open_images.py`` —
``sub-<split>-annotations-bbox.csv`` with normalized XMin/YMin/XMax/YMax
per (ImageID, ClassName) row, images under ``<root>/<split>``; exposes
the same ``get_annotation``/``get_image`` surface as the VOC dataset so
the mAP evaluator runs unchanged. (Unused by the published benchmarks,
mirrored for dataset-surface completeness.)
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, List

import numpy as np


class OpenImagesDataset:
    def __init__(self, root: str, dataset_type: str = "train"):
        self.root = root
        self.dataset_type = dataset_type.lower()
        self.data, self.class_names, self.class_dict = self._read_data()
        self.ids = [info["image_id"] for info in self.data]

    def _read_data(self):
        annotation_file = os.path.join(
            self.root, f"sub-{self.dataset_type}-annotations-bbox.csv"
        )
        by_image: Dict[str, List] = defaultdict(list)
        class_set = set()
        with open(annotation_file) as f:
            for row in csv.DictReader(f):
                class_set.add(row["ClassName"])
                by_image[row["ImageID"]].append(row)
        class_names = ["BACKGROUND"] + sorted(class_set)
        class_dict = {n: i for i, n in enumerate(class_names)}
        data = []
        for image_id, rows in by_image.items():
            boxes = np.array(
                [
                    [float(r["XMin"]), float(r["YMin"]),
                     float(r["XMax"]), float(r["YMax"])]
                    for r in rows
                ],
                np.float32,
            )
            labels = np.array(
                [class_dict[r["ClassName"]] for r in rows], np.int64
            )
            data.append({"image_id": image_id, "boxes": boxes, "labels": labels})
        return data, tuple(class_names), class_dict

    def __len__(self) -> int:
        return len(self.data)

    def _read_image(self, image_id: str) -> np.ndarray:
        import cv2

        path = os.path.join(self.root, self.dataset_type, image_id + ".jpg")
        image = cv2.imread(path)
        return cv2.cvtColor(image, cv2.COLOR_BGR2RGB)

    def get_annotation(self, index: int):
        info = self.data[index]
        image = self._read_image(info["image_id"])
        boxes = info["boxes"].copy()
        boxes[:, 0] *= image.shape[1]
        boxes[:, 1] *= image.shape[0]
        boxes[:, 2] *= image.shape[1]
        boxes[:, 3] *= image.shape[0]
        is_difficult = np.zeros(boxes.shape[0], np.uint8)
        return info["image_id"], (boxes, info["labels"], is_difficult)

    def get_image(self, index: int) -> np.ndarray:
        return self._read_image(self.data[index]["image_id"])
