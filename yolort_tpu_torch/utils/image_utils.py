"""Image reading, drawing and writing for HWC RGB arrays.

The port's own copy of the drawing helpers of
``yolort_tpu/utils/image_utils.py`` (``read_image_to_array``,
``plot_one_box``, ``overlay_boxes``, ``save_image``).  OpenCV is imported
inside each function that reads, draws or writes, as there.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from yolort_tpu_torch.data.builtin_meta import COCO_CLASSES, class_color


def read_image_to_array(path: str, rgb: bool = True) -> np.ndarray:
    """Read image -> float32 HWC in [0,1] (RGB by default)."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    if rgb:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return img.astype(np.float32) / 255.0


def plot_one_box(img_u8: np.ndarray, box, color=(128, 128, 128), label: Optional[str] = None,
                 line_thickness: Optional[int] = None) -> None:
    """Draw one xyxy box (+label) in place on a uint8 HWC image."""
    import cv2

    tl = line_thickness or max(round(0.002 * (img_u8.shape[0] + img_u8.shape[1]) / 2), 1)
    p1, p2 = (int(box[0]), int(box[1])), (int(box[2]), int(box[3]))
    cv2.rectangle(img_u8, p1, p2, color, tl, lineType=cv2.LINE_AA)
    if label:
        tf = max(tl - 1, 1)
        w, h = cv2.getTextSize(label, 0, tl / 3, tf)[0]
        p2t = p1[0] + w, p1[1] - h - 3
        cv2.rectangle(img_u8, p1, p2t, color, -1, cv2.LINE_AA)
        cv2.putText(img_u8, label, (p1[0], p1[1] - 2), 0, tl / 3, (255, 255, 255),
                    tf, lineType=cv2.LINE_AA)


def overlay_boxes(
    image: np.ndarray,
    prediction: Dict[str, np.ndarray],
    class_names: Sequence[str] = COCO_CLASSES,
    score_format: str = "{name} {score:.2f}",
) -> np.ndarray:
    """Render a detection dict onto an image; returns uint8 HWC RGB."""
    img = image
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    img = np.ascontiguousarray(img)
    for box, score, label in zip(
        prediction["boxes"], prediction["scores"], prediction["labels"]
    ):
        li = int(label)
        name = class_names[li] if li < len(class_names) else str(li)
        plot_one_box(
            img, box, color=class_color(li), label=score_format.format(name=name, score=float(score))
        )
    return img


def save_image(path: str, image_rgb_u8: np.ndarray) -> None:
    import cv2

    cv2.imwrite(str(path), cv2.cvtColor(image_rgb_u8, cv2.COLOR_RGB2BGR))
