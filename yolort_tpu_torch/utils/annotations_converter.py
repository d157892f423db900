"""YOLO-txt label folder -> COCO instances json.

Port of ``yolort_tpu/utils/annotations_converter.py`` (the reference's
AnnotationsConverter, yolort/utils/annotations_converter.py:11): each
image's ``<stem>.txt`` holds rows ``cls cx cy w h`` normalized; the output
is a COCO detection json that ``data.coco.COCODetection`` reads.  OpenCV
reads each image's size, imported when the first one is read.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Sequence


IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


class AnnotationsConverter:
    def __init__(
        self,
        image_root: str,
        label_root: str,
        metalabels: Sequence[str],
        year: Optional[int] = None,
    ):
        self.image_root = Path(image_root)
        self.label_root = Path(label_root)
        self.class_names = list(metalabels)
        self.year = year

    def _image_size(self, path: Path):
        import cv2

        img = cv2.imread(str(path))
        if img is None:
            raise FileNotFoundError(path)
        return img.shape[:2]

    def generate(self, output_path: Optional[str] = None) -> dict:
        images, annotations = [], []
        ann_id = 1
        img_paths = sorted(
            p for p in self.image_root.iterdir() if p.suffix.lower() in IMG_EXTS
        )
        for img_id, img_path in enumerate(img_paths):
            h, w = self._image_size(img_path)
            images.append(
                {"id": img_id, "file_name": img_path.name, "height": h, "width": w}
            )
            label_path = self.label_root / (img_path.stem + ".txt")
            if not label_path.exists():
                continue
            for line in label_path.read_text().strip().splitlines():
                parts = line.split()
                if len(parts) < 5:
                    continue
                cls = int(float(parts[0]))
                cx, cy, bw, bh = (float(v) for v in parts[1:5])
                x = (cx - bw / 2) * w
                y = (cy - bh / 2) * h
                annotations.append(
                    {
                        "id": ann_id,
                        "image_id": img_id,
                        "category_id": cls,
                        "bbox": [round(x, 2), round(y, 2), round(bw * w, 2), round(bh * h, 2)],
                        "area": round(bw * w * bh * h, 2),
                        "iscrowd": 0,
                    }
                )
                ann_id += 1

        coco = {
            "info": {"year": self.year} if self.year else {},
            "images": images,
            "annotations": annotations,
            "categories": [
                {"id": i, "name": name, "supercategory": name}
                for i, name in enumerate(self.class_names)
            ],
        }
        if output_path:
            with open(output_path, "w") as f:
                json.dump(coco, f)
        return coco
