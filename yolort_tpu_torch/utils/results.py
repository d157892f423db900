"""Rich detection results: the per-image dicts of ``YOLOv5.predict`` with
print, records, pandas, render, crop and save accessors.

The port's own copy of ``yolort_tpu/utils/results.py`` (importing it
through ``yolort_tpu`` would import JAX); pandas and OpenCV are imported
only by the accessors that use them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from yolort_tpu_torch.data.builtin_meta import COCO_CLASSES
from yolort_tpu_torch.utils.image_utils import overlay_boxes, save_image


class DetectionResults:
    """Batch of per-image detection results with convenience accessors."""

    def __init__(
        self,
        images: Sequence[np.ndarray],
        predictions: Sequence[Dict[str, np.ndarray]],
        names: Sequence[str] = COCO_CLASSES,
        files: Optional[Sequence[str]] = None,
    ):
        assert len(images) == len(predictions)
        self.images = [np.asarray(im) for im in images]
        self.predictions = list(predictions)
        self.names = list(names)
        self.files = list(files) if files else [f"image{i}.jpg" for i in range(len(images))]

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        return self.predictions[i]

    # ------------------------------------------------------------------
    def summary(self) -> str:
        lines = []
        for f, p in zip(self.files, self.predictions):
            counts: Dict[str, int] = {}
            for lbl in p["labels"]:
                name = self.names[int(lbl)] if int(lbl) < len(self.names) else str(int(lbl))
                counts[name] = counts.get(name, 0) + 1
            body = ", ".join(f"{v} {k}{'s' if v > 1 else ''}" for k, v in counts.items())
            lines.append(f"{f}: {body or 'no detections'}")
        return "\n".join(lines)

    def print(self) -> None:
        print(self.summary())

    # ------------------------------------------------------------------
    def records(self) -> List[List[Dict]]:
        """Per-image list of detection records (xmin..confidence..name)."""
        out = []
        for p in self.predictions:
            rows = []
            for box, score, lbl in zip(p["boxes"], p["scores"], p["labels"]):
                rows.append(
                    {
                        "xmin": float(box[0]),
                        "ymin": float(box[1]),
                        "xmax": float(box[2]),
                        "ymax": float(box[3]),
                        "confidence": float(score),
                        "class": int(lbl),
                        "name": self.names[int(lbl)] if int(lbl) < len(self.names) else str(int(lbl)),
                    }
                )
            out.append(rows)
        return out

    def pandas(self):
        """List of per-image DataFrames (requires pandas)."""
        import pandas as pd

        return [pd.DataFrame(rows) for rows in self.records()]

    # ------------------------------------------------------------------
    def render(self) -> List[np.ndarray]:
        """Overlay boxes on copies of the images; returns uint8 RGB."""
        return [
            overlay_boxes(im.copy(), p, self.names)
            for im, p in zip(self.images, self.predictions)
        ]

    def crop(self, save_dir: Optional[str] = None) -> List[Dict]:
        """Crop each detection from its image (reference common.py crop)."""
        crops = []
        for im, p, f in zip(self.images, self.predictions, self.files):
            h, w = im.shape[:2]
            for j, (box, score, lbl) in enumerate(zip(p["boxes"], p["scores"], p["labels"])):
                x1, y1, x2, y2 = (int(max(0, box[0])), int(max(0, box[1])),
                                  int(min(w, box[2])), int(min(h, box[3])))
                if x2 <= x1 or y2 <= y1:
                    continue
                crop = im[y1:y2, x1:x2]
                name = self.names[int(lbl)] if int(lbl) < len(self.names) else str(int(lbl))
                entry = {"box": np.asarray(box), "conf": float(score), "cls": int(lbl),
                         "label": name, "im": crop}
                if save_dir:
                    out = Path(save_dir) / name
                    out.mkdir(parents=True, exist_ok=True)
                    u8 = crop if crop.dtype == np.uint8 else (np.clip(crop, 0, 1) * 255).astype(np.uint8)
                    save_image(str(out / f"{Path(f).stem}_{j}.jpg"), u8)
                crops.append(entry)
        return crops

    def save(self, save_dir: str = "runs/detect") -> List[str]:
        out_dir = Path(save_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        paths = []
        for rendered, f in zip(self.render(), self.files):
            path = str(out_dir / Path(f).name)
            save_image(path, rendered)
            paths.append(path)
        return paths
