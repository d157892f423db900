"""Streaming image/video sources for inference.

Port of ``yolort_tpu/data/datasets.py`` (the reference's ``LoadImages``,
yolort/v5/utils/datasets.py:56): glob a path of images and/or videos and
iterate (path, image) pairs as RGB float32 HWC, the format
``YOLOv5.__call__`` takes.  EXIF orientation is honoured for images.
Images are read with PIL and videos with OpenCV, each imported when the
first file of its kind is read.
"""

from __future__ import annotations

import glob
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np

IMG_FORMATS = ("bmp", "jpg", "jpeg", "png", "tif", "tiff", "webp")
VID_FORMATS = ("avi", "gif", "m4v", "mkv", "mov", "mp4", "mpeg", "mpg", "webm")


def exif_transpose(pil_img):
    """Apply EXIF orientation (reference datasets.py:25)."""
    from PIL import Image

    try:
        exif = pil_img.getexif()
        orientation = exif.get(0x0112, 1)
    except Exception:
        return pil_img
    transforms = {
        2: Image.FLIP_LEFT_RIGHT,
        3: Image.ROTATE_180,
        4: Image.FLIP_TOP_BOTTOM,
        5: Image.TRANSPOSE,
        6: Image.ROTATE_270,
        7: Image.TRANSVERSE,
        8: Image.ROTATE_90,
    }
    if orientation in transforms:
        pil_img = pil_img.transpose(transforms[orientation])
    return pil_img


class LoadImages:
    """Iterate images and video frames from a file, directory, or glob."""

    def __init__(self, path: str):
        p = str(Path(path).resolve())
        if "*" in p:
            files = sorted(glob.glob(p, recursive=True))
        elif Path(p).is_dir():
            files = sorted(glob.glob(str(Path(p) / "*")))
        elif Path(p).is_file():
            files = [p]
        else:
            raise FileNotFoundError(p)
        self.images = [f for f in files if f.split(".")[-1].lower() in IMG_FORMATS]
        self.videos = [f for f in files if f.split(".")[-1].lower() in VID_FORMATS]
        if not self.images and not self.videos:
            raise FileNotFoundError(f"no images/videos under {p}")

    def __len__(self) -> int:
        return len(self.images) + len(self.videos)

    def _read_image(self, path: str) -> np.ndarray:
        from PIL import Image

        img = exif_transpose(Image.open(path).convert("RGB"))
        return np.asarray(img, np.float32) / 255.0

    def __iter__(self) -> Iterator[Tuple[str, np.ndarray]]:
        for f in self.images:
            yield f, self._read_image(f)
        for f in self.videos:
            import cv2

            cap = cv2.VideoCapture(f)
            idx = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                rgb = cv2.cvtColor(frame, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
                yield f"{f}#frame{idx}", rgb
                idx += 1
            cap.release()
