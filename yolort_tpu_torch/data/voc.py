"""Pascal VOC detection dataset with COCO-style targets.

Port of ``yolort_tpu/data/voc.py``: the VOC XML annotations parsed with
ElementTree into the targets ``COCODetection`` gives (boxes xyxy,
0-indexed; labels; iscrowd; area; orig_size), the images read with OpenCV
as RGB float32 in [0, 1].
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class VOCDetection:
    """VOCdevkit-layout dataset: root/{JPEGImages,Annotations,ImageSets}."""

    def __init__(self, root: str, image_set: str = "train", year: str = "2012",
                 transforms=None, keep_difficult: bool = False):
        self.root = Path(root)
        self.transforms = transforms
        self.keep_difficult = keep_difficult
        base = self.root
        if (self.root / f"VOC{year}").exists():
            base = self.root / f"VOC{year}"
        self.img_dir = base / "JPEGImages"
        self.ann_dir = base / "Annotations"
        split_file = base / "ImageSets" / "Main" / f"{image_set}.txt"
        if split_file.exists():
            self.ids = [l.strip() for l in split_file.read_text().splitlines() if l.strip()]
        else:
            self.ids = sorted(p.stem for p in self.ann_dir.glob("*.xml"))
        self.class_to_idx = {name: i for i, name in enumerate(VOC_CLASSES)}

    def __len__(self) -> int:
        return len(self.ids)

    def _parse_annotation(self, stem: str) -> Dict[str, np.ndarray]:
        tree = ET.parse(self.ann_dir / f"{stem}.xml")
        size = tree.find("size")
        h = int(size.find("height").text)
        w = int(size.find("width").text)
        boxes, labels, difficult = [], [], []
        for obj in tree.iter("object"):
            diff = int((obj.find("difficult").text or "0")) if obj.find("difficult") is not None else 0
            if diff and not self.keep_difficult:
                continue
            name = obj.find("name").text.strip().lower()
            if name not in self.class_to_idx:
                continue
            bb = obj.find("bndbox")
            # VOC is 1-indexed, inclusive
            x1 = float(bb.find("xmin").text) - 1
            y1 = float(bb.find("ymin").text) - 1
            x2 = float(bb.find("xmax").text) - 1
            y2 = float(bb.find("ymax").text) - 1
            boxes.append([max(x1, 0), max(y1, 0), min(x2, w), min(y2, h)])
            labels.append(self.class_to_idx[name])
            difficult.append(diff)
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        return {
            "boxes": boxes,
            "labels": np.asarray(labels, np.int64),
            "iscrowd": np.zeros(len(labels), np.int64),
            "area": (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]),
            "orig_size": np.asarray([h, w]),
        }

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        import cv2

        stem = self.ids[idx]
        img = cv2.imread(str(self.img_dir / f"{stem}.jpg"), cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(self.img_dir / f"{stem}.jpg")
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        target = self._parse_annotation(stem)
        target["image_id"] = np.asarray(idx)
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, target
