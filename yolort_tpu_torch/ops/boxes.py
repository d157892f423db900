"""Box geometry on xyxy / cxcywh tensors, in the operation order of the
box ops of ``yolort_tpu/ops/nms.py``, so results agree bit for bit.

Every function broadcasts over leading dimensions."""

from __future__ import annotations

import torch


def box_area(b: torch.Tensor) -> torch.Tensor:
    return (b[..., 2] - b[..., 0]).clamp_min(0.0) * (b[..., 3] - b[..., 1]).clamp_min(0.0)


def box_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes, (..., M, 4) x (..., N, 4) -> (..., M, N)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / union.clamp_min(1e-12)


def cxcywh_to_xyxy(box: torch.Tensor) -> torch.Tensor:
    cx, cy, w, h = box[..., 0], box[..., 1], box[..., 2], box[..., 3]
    return torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1)
