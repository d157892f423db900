"""Detection visualizer: instance predictions (or ground truth) drawn with
class-colored boxes and score labels; the class names from a sequence, a
file (one a line) or, by default, COCO's.

Port of ``yolort_tpu/utils/visualizer.py`` on the port's
``image_utils.overlay_boxes`` and ``save_image``."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence, Union

import numpy as np

from yolort_tpu_torch.data.builtin_meta import COCO_CLASSES
from yolort_tpu_torch.utils.image_utils import overlay_boxes, save_image


class Visualizer:
    def __init__(self, image: np.ndarray, metalabels: Union[Sequence[str], str, None] = None):
        """image: HWC uint8, or float in [0, 1], RGB."""
        if image.dtype != np.uint8:
            image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
        self.image = np.ascontiguousarray(image)
        if metalabels is None:
            self.class_names = list(COCO_CLASSES)
        elif isinstance(metalabels, (str, Path)):
            self.class_names = [line.strip() for line in Path(metalabels).read_text().splitlines()
                                if line.strip()]
        else:
            self.class_names = list(metalabels)

    def draw_instance_predictions(self, predictions: Dict[str, np.ndarray]) -> np.ndarray:
        """predictions: {'boxes', 'scores', 'labels'} in image coordinates."""
        self.image = overlay_boxes(self.image, predictions, self.class_names)
        return self.image

    def draw_ground_truth(self, target: Dict[str, np.ndarray]) -> np.ndarray:
        fake = {
            "boxes": np.asarray(target["boxes"]),
            "scores": np.ones(len(target["boxes"]), np.float32),
            "labels": np.asarray(target["labels"]),
        }
        self.image = overlay_boxes(self.image, fake, self.class_names, score_format="{name}")
        return self.image

    def save(self, path: str) -> None:
        save_image(path, self.image)

    def imshow(self, scale: float = 1.0):  # pragma: no cover - needs a display
        import cv2

        img = self.image
        if scale != 1.0:
            img = cv2.resize(img, None, fx=scale, fy=scale)
        cv2.imshow("yolort_tpu_torch", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        cv2.waitKey(0)
