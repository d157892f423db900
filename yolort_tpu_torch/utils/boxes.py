"""Box coordinate utilities (numpy + torch polymorphic).

Port of ``yolort_tpu/utils/boxes.py`` (the reference's coordinate
converters, yolort/v5/utils/general.py:391-517): each function takes a
numpy array or a torch tensor and returns the same kind, through the few
array ops below.
"""

from __future__ import annotations

import numpy as np
import torch


class _TorchOps:
    """The numpy functions the converters use, on tensors."""

    @staticmethod
    def stack(xs, axis=0):
        return torch.stack(xs, dim=axis)

    @staticmethod
    def clip(x, lo, hi):
        return torch.clamp(x, lo, hi)

    @staticmethod
    def maximum(a, b):
        return torch.maximum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))

    @staticmethod
    def minimum(a, b):
        return torch.minimum(a, torch.as_tensor(b, dtype=a.dtype, device=a.device))


def _xp(x):
    return _TorchOps if isinstance(x, torch.Tensor) else np


def xyxy2xywh(x):
    """xyxy -> (cx, cy, w, h)."""
    xp = _xp(x)
    return xp.stack(
        [
            (x[..., 0] + x[..., 2]) / 2,
            (x[..., 1] + x[..., 3]) / 2,
            x[..., 2] - x[..., 0],
            x[..., 3] - x[..., 1],
        ],
        axis=-1,
    )


def xywh2xyxy(x):
    """(cx, cy, w, h) -> xyxy."""
    xp = _xp(x)
    return xp.stack(
        [
            x[..., 0] - x[..., 2] / 2,
            x[..., 1] - x[..., 3] / 2,
            x[..., 0] + x[..., 2] / 2,
            x[..., 1] + x[..., 3] / 2,
        ],
        axis=-1,
    )


def xywhn2xyxy(x, w: float = 640, h: float = 640, padw: float = 0, padh: float = 0):
    """normalized (cx, cy, w, h) -> pixel xyxy with optional pad offset."""
    xp = _xp(x)
    return xp.stack(
        [
            w * (x[..., 0] - x[..., 2] / 2) + padw,
            h * (x[..., 1] - x[..., 3] / 2) + padh,
            w * (x[..., 0] + x[..., 2] / 2) + padw,
            h * (x[..., 1] + x[..., 3] / 2) + padh,
        ],
        axis=-1,
    )


def xyxy2xywhn(x, w: float = 640, h: float = 640, clip: bool = False, eps: float = 0.0):
    """pixel xyxy -> normalized (cx, cy, w, h)."""
    if clip:
        x = clip_boxes(x, (h - eps, w - eps))
    xp = _xp(x)
    return xp.stack(
        [
            (x[..., 0] + x[..., 2]) / 2 / w,
            (x[..., 1] + x[..., 3]) / 2 / h,
            (x[..., 2] - x[..., 0]) / w,
            (x[..., 3] - x[..., 1]) / h,
        ],
        axis=-1,
    )


def xyn2xy(x, w: float = 640, h: float = 640, padw: float = 0, padh: float = 0):
    """normalized point segments -> pixel points."""
    xp = _xp(x)
    return xp.stack([w * x[..., 0] + padw, h * x[..., 1] + padh], axis=-1)


def clip_boxes(boxes, shape):
    """Clamp xyxy boxes to image (h, w)."""
    xp = _xp(boxes)
    h, w = shape
    return xp.stack(
        [
            xp.clip(boxes[..., 0], 0, w),
            xp.clip(boxes[..., 1], 0, h),
            xp.clip(boxes[..., 2], 0, w),
            xp.clip(boxes[..., 3], 0, h),
        ],
        axis=-1,
    )


def box_area(b):
    xp = _xp(b)
    return xp.clip(b[..., 2] - b[..., 0], 0, None) * xp.clip(b[..., 3] - b[..., 1], 0, None)


def box_iou(a, b):
    """Pairwise IoU between (M,4) and (N,4) xyxy -> (M,N)."""
    xp = _xp(a)
    lt = xp.maximum(a[:, None, :2], b[None, :, :2])
    rb = xp.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = xp.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    return inter / xp.maximum(box_area(a)[:, None] + box_area(b)[None, :] - inter, 1e-12)


def wh_iou(wh1, wh2):
    """IoU of width-height pairs assuming co-centered boxes: (M,2),(N,2)->(M,N)."""
    xp = _xp(wh1)
    inter = xp.minimum(wh1[:, None, 0], wh2[None, :, 0]) * xp.minimum(
        wh1[:, None, 1], wh2[None, :, 1]
    )
    union = wh1[:, 0:1] * wh1[:, 1:2] + (wh2[:, 0] * wh2[:, 1])[None, :] - inter
    return inter / xp.maximum(union, 1e-12)


def bbox_ioa(box1, box2, eps: float = 1e-7):
    """Intersection over box2 area: (4,), (N,4) -> (N,)."""
    xp = _xp(box2)
    ix = xp.clip(xp.minimum(box1[2], box2[:, 2]) - xp.maximum(box1[0], box2[:, 0]), 0, None)
    iy = xp.clip(xp.minimum(box1[3], box2[:, 3]) - xp.maximum(box1[1], box2[:, 1]), 0, None)
    area2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    return ix * iy / (area2 + eps)
