"""COCO detection dataset, dependency-free (no pycocotools/torchvision).

Re-design of ``COCODetection`` + ``ConvertCocoPolysToMask``
(yolort/data/coco.py:14,32): parses the annotation json directly, converts
xywh -> clamped xyxy, maps category ids to a contiguous [0, C) range, and
filters degenerate boxes.  Images load through the port's ``read_image``
(cv2, imported when an image is read) as RGB float32 HWC in [0, 1].
Port of ``yolort_tpu/data/coco.py``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

from yolort_tpu_torch.models.yolov5 import read_image


class COCODetection:
    def __init__(self, img_folder: str, ann_file: str, transforms=None):
        self.root = Path(img_folder)
        self.transforms = transforms
        with open(ann_file) as f:
            coco = json.load(f)

        self.images = {img["id"]: img for img in coco["images"]}
        cat_ids = sorted(c["id"] for c in coco.get("categories", []))
        # contiguous category mapping (reference coco.py:19-24)
        self.json_category_id_to_contiguous_id = {cid: i for i, cid in enumerate(cat_ids)}
        self.contiguous_category_id_to_json_id = {i: cid for cid, i in
                                                  self.json_category_id_to_contiguous_id.items()}
        self.categories = {c["id"]: c.get("name", str(c["id"])) for c in coco.get("categories", [])}

        anns_by_img: Dict[int, List[dict]] = {}
        for ann in coco.get("annotations", []):
            anns_by_img.setdefault(ann["image_id"], []).append(ann)
        self.anns_by_img = anns_by_img
        self.ids = sorted(self.images.keys())

    def __len__(self) -> int:
        return len(self.ids)

    def _load_image(self, file_name: str) -> np.ndarray:
        return read_image(str(self.root / file_name))

    def get_target(self, image_id: int) -> Dict[str, np.ndarray]:
        """All annotations, crowds included and flagged via ``iscrowd`` so the
        evaluator can apply pycocotools crowd-ignore semantics.  The reference
        strips crowds only when assembling *training* targets (its eval runs
        pycocotools on the full annotation file); here the training-side crowd
        filter lives in DetectionDataModule."""
        info = self.images[image_id]
        h, w = info["height"], info["width"]
        anns = self.anns_by_img.get(image_id, [])
        boxes = np.asarray([a["bbox"] for a in anns], np.float32).reshape(-1, 4)
        # xywh -> xyxy, clamp to image (reference coco.py:46-53)
        boxes[:, 2:] += boxes[:, :2]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
        labels = np.asarray(
            [self.json_category_id_to_contiguous_id[a["category_id"]] for a in anns],
            np.int64,
        )
        area = np.asarray([a.get("area", 0.0) for a in anns], np.float32)
        iscrowd = np.asarray([a.get("iscrowd", 0) for a in anns], np.int64)
        # degenerate-box filter (reference coco.py:69-73)
        keep = (boxes[:, 3] > boxes[:, 1]) & (boxes[:, 2] > boxes[:, 0])
        return {
            "image_id": np.asarray(image_id),
            "boxes": boxes[keep],
            "labels": labels[keep],
            "area": area[keep],
            "iscrowd": iscrowd[keep],
            "orig_size": np.asarray([h, w]),
        }

    def __getitem__(self, idx: int) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        image_id = self.ids[idx]
        img = self._load_image(self.images[image_id]["file_name"])
        target = self.get_target(image_id)
        if self.transforms is not None:
            img, target = self.transforms(img, target)
        return img, target
