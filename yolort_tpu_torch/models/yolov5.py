"""End-to-end YOLOv5: letterbox + model + postprocess + box rescale.

Port of ``yolort_tpu/models/yolov5.py``.  ``__call__`` groups images of one
raw size into a batch (a shape bucket) and runs the whole pipeline on the
model's device: uint8 frames are normalised there, float images are taken
as [0, 1].  ``load_from_yolov5`` builds one from an ultralytics checkpoint.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolort_tpu_torch.models._bridge import params_from_jax
from yolort_tpu_torch.models._checkpoint import load_from_ultralytics
from yolort_tpu_torch.models.transform import letterbox_batch, make_plan, scale_coords_back
from yolort_tpu_torch.models.yolo import YOLO, build_yolo, resolve_device
from yolort_tpu_torch.ops.nms import Detections


def read_image(path: str) -> np.ndarray:
    """Default loader: RGB float32 in [0, 1], HWC."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


class YOLOv5:
    """User-facing end-to-end model.  ``size`` is the (min_size, max_size)
    letterbox target, ``size_divisible`` the canvas rounding,
    ``fill_color`` the pad value; ``device`` (the card unless the caller
    passes ``"cpu"``; a CUDA device where there is none raises) and
    ``dtype`` (float32 or bfloat16) place the model.  A ``model`` passed in
    is served where its parameters lie; a ``device`` given beside it must
    be that one."""

    def __init__(
        self,
        arch: Optional[str] = None,
        model: Optional[YOLO] = None,
        *,
        device=None,
        num_classes: int = 80,
        size: Tuple[int, int] = (640, 640),
        size_divisible: int = 32,
        fill_color: int = 114,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        **kwargs: Any,
    ) -> None:
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        if model is None:
            device = resolve_device("cuda" if device is None else device)
            model = build_yolo(arch, device=device, num_classes=num_classes, dtype=dtype,
                               seed=seed, **kwargs)
        else:
            # a quantized model keeps its weights as buffers, not parameters
            first = next(itertools.chain(model.parameters(), model.buffers()))
            where = first.device
            device = where if device is None else resolve_device(device)
            if device.type != where.type or device.index not in (None, where.index):
                raise ValueError(f"device {str(device)!r} differs from the model's {str(where)!r}")
        self.arch = arch
        self.model = model
        self.device = device
        self.num_classes = model.num_classes
        self.size = size
        self.size_divisible = size_divisible
        self.fill_color = fill_color
        self.dtype = dtype

    @classmethod
    def load_from_yolov5(
        cls,
        checkpoint_path: str,
        *,
        version: str = "r6.0",
        device="cuda",
        dtype: torch.dtype = torch.float32,
        size: Tuple[int, int] = (640, 640),
        size_divisible: int = 32,
        fill_color: int = 114,
        score_thresh: float = 0.25,
        nms_thresh: float = 0.45,
        **kwargs: Any,
    ) -> "YOLOv5":
        """Build from an ultralytics/yolov5 checkpoint: the architecture
        (depth, width, classes, P6, strides and anchors) from its metadata,
        the weights from its tree (``models/_checkpoint.py``).  ``version``
        names the family, as the checkpoint does not; a TAN checkpoint
        loads as 'r4.0' with ``use_tan=True``, passed on to ``YOLO`` with
        the other ``kwargs``."""
        info = load_from_ultralytics(checkpoint_path, version=version)
        model = YOLO(info["depth_multiple"], info["width_multiple"], device=device, dtype=dtype,
                     version=version, num_classes=info["num_classes"], use_p6=info["use_p6"],
                     strides=info["strides"], anchor_grids=info["anchor_grids"],
                     score_thresh=score_thresh, nms_thresh=nms_thresh, **kwargs)
        params_from_jax(info["params"], model)
        return cls(model=model, size=size, size_divisible=size_divisible, fill_color=fill_color,
                   dtype=dtype)

    def canvas(self, raw: torch.Tensor):
        """(canvas, plan) of raw (B, H, W, 3) uint8 or float in [0, 1], one
        shape bucket: the letterboxed batch the model takes, in its dtype,
        and the ``LetterboxPlan`` that made it."""
        _, h, w, _ = raw.shape
        plan = make_plan([(h, w)], min_size=self.size[0], max_size=self.size[1],
                         size_divisible=self.size_divisible)[0]
        x = raw.to(self.dtype) * (1.0 / 255.0) if raw.dtype == torch.uint8 else raw.to(self.dtype)
        return letterbox_batch(x, plan, self.fill_color / 255.0), plan

    @torch.inference_mode()
    def _infer(self, raw: torch.Tensor) -> Detections:
        """raw: (B, H, W, 3) uint8 or float in [0, 1], one shape bucket, on
        the model's device."""
        _, h, w, _ = raw.shape
        canvas, plan = self.canvas(raw)
        det = self.model(canvas)
        orig = torch.tensor([h, w], dtype=torch.float32, device=raw.device)
        return det._replace(boxes=scale_coords_back(det.boxes, plan.canvas_hw, orig))

    def __call__(self, inputs: Sequence[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """Detect on a list of HWC images (uint8, or float in [0, 1]);
        same-size images share one batch."""
        images = [np.asarray(x) for x in inputs]
        results: List[Optional[Dict[str, np.ndarray]]] = [None] * len(images)
        groups: Dict[Tuple[Tuple[int, int], np.dtype], List[int]] = {}
        for i, im in enumerate(images):
            if im.ndim != 3 or im.shape[-1] != 3:
                raise ValueError(f"expected an HWC image with 3 channels, got shape {im.shape}")
            dt = np.dtype(np.uint8) if im.dtype == np.uint8 else np.dtype(np.float32)
            groups.setdefault((im.shape[:2], dt), []).append(i)
        for (_, dt), idxs in groups.items():
            batch = torch.from_numpy(np.stack([images[i].astype(dt, copy=False) for i in idxs]))
            det = self._infer(batch.to(self.device))
            boxes, scores, labels, num = (
                det.boxes.float().cpu().numpy(), det.scores.float().cpu().numpy(),
                det.labels.cpu().numpy(), det.num.cpu().numpy(),
            )
            for j, i in enumerate(idxs):
                n = int(num[j])
                results[i] = {
                    "boxes": boxes[j, :n],
                    "scores": scores[j, :n],
                    "labels": labels[j, :n].astype(np.int64),
                }
        return results  # type: ignore[return-value]

    def predict(self, x: Any, image_loader: Optional[Callable] = None) -> List[Dict[str, np.ndarray]]:
        """Detect on a path, an HWC array, or a list of either."""
        loader = image_loader or read_image
        if isinstance(x, str) or (isinstance(x, np.ndarray) and x.ndim == 3):
            x = [x]
        images = [loader(s) if isinstance(s, str) else np.asarray(s) for s in x]
        return self(images)
