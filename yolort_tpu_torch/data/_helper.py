"""Dataset helpers (port of ``yolort_tpu/data/_helper.py``).

Capability parity with yolort/data/_helper.py (prepare_coco128:50,
get_dataset/get_dataloader:80-115, create_small_table:14).  The reference
downloads coco128 from a GitHub release; this environment has zero egress,
so ``prepare_coco128`` uses a pre-seeded zip/directory if present and
``create_synthetic_coco`` fabricates a small labeled dataset for harness
tests."""

from __future__ import annotations

import json
import zipfile
from pathlib import Path
from typing import Tuple

import numpy as np


def create_small_table(d: dict) -> str:
    """Two-row table of a small metric dict (coco_eval result printing)."""
    keys = list(d.keys())
    vals = [f"{d[k]:.3f}" if isinstance(d[k], float) else str(d[k]) for k in keys]
    w = [max(len(k), len(v)) for k, v in zip(keys, vals)]
    header = " | ".join(k.ljust(wi) for k, wi in zip(keys, w))
    sep = "-|-".join("-" * wi for wi in w)
    row = " | ".join(v.ljust(wi) for v, wi in zip(vals, w))
    return "\n".join([header, sep, row])


def prepare_coco128(data_path: str, dirname: str = "coco128") -> Path:
    """Locate (or unpack) a local coco128 copy.

    The reference downloads coco128.zip from its release page
    (_helper.py:50-71); here the zip or directory must be pre-seeded under
    ``data_path`` (no network egress)."""
    root = Path(data_path)
    target = root / dirname
    if target.is_dir():
        return target
    zip_path = root / f"{dirname}.zip"
    if zip_path.exists():
        with zipfile.ZipFile(zip_path) as zf:
            zf.extractall(root)
        if target.is_dir():
            return target
    raise FileNotFoundError(
        f"coco128 not found under {root} — pre-seed {dirname}/ or {dirname}.zip "
        "(no network egress in this environment)"
    )


def create_synthetic_coco(
    path: str,
    num_images: int = 8,
    num_classes: int = 3,
    image_hw: Tuple[int, int] = (160, 160),
    seed: int = 0,
) -> Tuple[str, str]:
    """Fabricate a small COCO-format detection dataset with visually
    learnable objects (bright rectangles per class).  Returns
    (image_dir, annotation_file)."""
    import cv2

    rng = np.random.default_rng(seed)
    root = Path(path)
    img_dir = root / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    h, w = image_hw
    colors = [(255, 64, 64), (64, 255, 64), (64, 64, 255)]
    images, annotations = [], []
    ann_id = 1
    for i in range(num_images):
        img = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
        n_obj = int(rng.integers(1, 4))
        for _ in range(n_obj):
            cls = int(rng.integers(0, num_classes))
            bw, bh = int(rng.integers(30, 60)), int(rng.integers(30, 60))
            x = int(rng.integers(0, w - bw))
            y = int(rng.integers(0, h - bh))
            cv2.rectangle(img, (x, y), (x + bw, y + bh), colors[cls % 3], -1)
            annotations.append(
                {
                    "id": ann_id,
                    "image_id": i,
                    "category_id": cls + 1,
                    "bbox": [x, y, bw, bh],
                    "area": bw * bh,
                    "iscrowd": 0,
                }
            )
            ann_id += 1
        fn = f"synthetic_{i:04d}.jpg"
        cv2.imwrite(str(img_dir / fn), img)
        images.append({"id": i, "file_name": fn, "height": h, "width": w})

    ann_file = root / "annotations.json"
    with open(ann_file, "w") as f:
        json.dump(
            {
                "images": images,
                "annotations": annotations,
                "categories": [
                    {"id": c + 1, "name": f"class{c}"} for c in range(num_classes)
                ],
            },
            f,
        )
    return str(img_dir), str(ann_file)


def get_dataset(image_path: str, annotation_path: str, transforms=None):
    from yolort_tpu_torch.data.coco import COCODetection

    return COCODetection(image_path, annotation_path, transforms=transforms)


def get_dataloader(
    dataset,
    batch_size: int = 16,
    canvas_hw: Tuple[int, int] = (640, 640),
    **kwargs,
):
    from yolort_tpu_torch.data.data_module import DetectionDataModule

    return DetectionDataModule(dataset, batch_size=batch_size, canvas_hw=canvas_hw, **kwargs)
