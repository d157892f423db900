"""The plain reference of the path ``YOLOv5.__call__`` drives: letterbox,
network, decode, score threshold, top-k, class-wise greedy NMS and the
rescale of boxes to frame coordinates.

Written from the published yolort semantics, in plain PyTorch, and
independent of the program under test (it imports nothing of it):

* letterbox: scale = min(min_size / min(h, w), max_size / max(h, w)),
  resized sides floored, canvas rounded up to ``size_divisible`` (or the
  fixed canvas), offsets int(round(d / 2 - 0.1)), bilinear resize with
  half-pixel centres and no antialias, fill 114 / 255;
* decode: xy = (2 sigmoid - 0.5 + grid) * stride, wh = (2 sigmoid)^2 *
  anchor; a pair's score is sigmoid(obj) * sigmoid(cls);
* selection: the pairs scoring above ``score_thresh``, the best
  ``pre_nms_topk`` of them;
* NMS: greedy in descending score, a box suppressed by an earlier kept
  box of its class whose IoU with it is above ``nms_thresh``; the first
  ``detections_per_img`` kept;
* rescale: gain = min(canvas_h / h, canvas_w / w), pad = (canvas - size *
  gain) / 2, frame coordinate = (canvas coordinate - pad) / gain.

Everything runs in float32 on the device the network is on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import models

FILL = 114.0 / 255.0


@dataclass(frozen=True)
class Plan:
    resized: Tuple[int, int]
    canvas: Tuple[int, int]
    offset: Tuple[int, int]


def plan(hw: Tuple[int, int], size: Tuple[int, int], divisible: int,
         fixed: Optional[Tuple[int, int]] = None) -> Plan:
    """The letterbox of one frame of (h, w) alone, or onto ``fixed``."""
    h, w = hw
    scale = min(float(size[0]) / min(h, w), float(size[1]) / max(h, w))
    rh, rw = int(math.floor(h * scale)), int(math.floor(w * scale))
    if fixed is not None:
        ch, cw = int(fixed[0]), int(fixed[1])
    else:
        ch = int(math.ceil(rh / divisible) * divisible)
        cw = int(math.ceil(rw / divisible) * divisible)
    return Plan((rh, rw), (ch, cw), (int(round((ch - rh) / 2 - 0.1)), int(round((cw - rw) / 2 - 0.1))))


def letterbox(frame: torch.Tensor, p: Plan) -> torch.Tensor:
    """uint8 HWC frame -> float32 (3, ch, cw) canvas in [0, 1]."""
    x = frame.permute(2, 0, 1)[None].float() / 255.0
    if p.resized != tuple(x.shape[2:]):
        x = F.interpolate(x, size=p.resized, mode="bilinear", align_corners=False, antialias=False)
    out = torch.full((3, *p.canvas), FILL, dtype=torch.float32, device=frame.device)
    dh, dw = p.offset
    out[:, dh:dh + p.resized[0], dw:dw + p.resized[1]] = x[0]
    return out


def decode(logits: Sequence[torch.Tensor], strides: Sequence[int], anchors: Sequence[Sequence[float]]):
    """Per-level raw logits (B, A, H, W, 5 + nc) -> boxes (B, N, 4) xyxy on
    the canvas and pair scores (B, N, nc), every anchor of every level."""
    boxes, scores = [], []
    for lg, stride, anc in zip(logits, strides, anchors):
        b, a, ny, nx, _ = lg.shape
        y = torch.sigmoid(lg.float())
        gy, gx = torch.meshgrid(torch.arange(ny, device=lg.device, dtype=torch.float32),
                                torch.arange(nx, device=lg.device, dtype=torch.float32),
                                indexing="ij")
        wh_anchor = torch.tensor(anc, dtype=torch.float32, device=lg.device).view(1, a, 1, 1, 2)
        cx = (y[..., 0] * 2.0 - 0.5 + gx) * stride
        cy = (y[..., 1] * 2.0 - 0.5 + gy) * stride
        wh = (y[..., 2:4] * 2.0) ** 2 * wh_anchor
        xyxy = torch.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2,
                            cx + wh[..., 0] / 2, cy + wh[..., 1] / 2], dim=-1)
        boxes.append(xyxy.reshape(b, -1, 4))
        scores.append((y[..., 5:] * y[..., 4:5]).reshape(b, -1, y.shape[-1] - 5))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of xyxy boxes a (..., N, 4) and b (..., M, 4) -> (..., N, M)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    return inter / (area_a[..., :, None] + area_b[..., None, :] - inter)


def greedy_nms(boxes: torch.Tensor, labels: torch.Tensor, valid: torch.Tensor,
               iou_thresh: float, stop_after: int) -> torch.Tensor:
    """Keep mask (B, K) of score-sorted candidates: each kept unless an
    earlier kept candidate of its label overlaps it by IoU > iou_thresh.
    Exact for the first ``stop_after`` kept of each image."""
    k = boxes.shape[1]
    idx = torch.arange(k, device=boxes.device)
    over = ((box_iou(boxes, boxes) > iou_thresh) & (labels[:, :, None] == labels[:, None, :])
            & (idx[None, :] > idx[:, None])[None])
    suppressed = ~valid
    keep = torch.zeros_like(valid)
    for i in range(k):
        k_i = ~suppressed[:, i]
        keep[:, i] = k_i
        suppressed = suppressed | (over[:, i, :] & k_i[:, None])
        if i % 256 == 255 and bool((keep.sum(1) >= stop_after).all() | ~valid[:, i + 1:].any()):
            break  # what follows can no longer be among the first stop_after kept
    return keep


@dataclass
class Reference:
    """One frame's reference: every anchor's box and pair scores in frame
    coordinates, the kept detections, and the score of the last pair the
    top-k cut admits (``score_thresh`` where the cut admitted all)."""

    boxes: torch.Tensor   # (N, 4)
    scores: torch.Tensor  # (N, nc)
    det_boxes: torch.Tensor   # (D, 4)
    det_scores: torch.Tensor  # (D,)
    det_labels: torch.Tensor  # (D,)
    topk_floor: float


def rescale(boxes: torch.Tensor, canvas: Tuple[int, int], hw: Tuple[int, int]) -> torch.Tensor:
    ch, cw = float(canvas[0]), float(canvas[1])
    h, w = float(hw[0]), float(hw[1])
    gain = min(ch / h, cw / w)
    pad = torch.tensor([(cw - w * gain) / 2, (ch - h * gain) / 2] * 2, device=boxes.device)
    return (boxes - pad) / gain


def postprocess(boxes: torch.Tensor, scores: torch.Tensor, post: dict):
    """Threshold, top-k and NMS of one batch on its canvas: per image
    (kept boxes, scores, labels) and the top-k floor."""
    thr = float(np.float32(post["score_thresh"]))
    b, n, nc = scores.shape
    flat = scores.reshape(b, -1)
    k = min(int(post["pre_nms_topk"]), flat.shape[1])
    top, idx = torch.topk(flat, k, dim=1)
    valid = top > thr
    floor = torch.where(valid[:, -1], top[:, -1], torch.full_like(top[:, -1], thr))
    cand = torch.gather(boxes, 1, (idx // nc)[..., None].expand(-1, -1, 4))
    labels = idx % nc
    d = int(post["detections_per_img"])
    keep = greedy_nms(cand, labels, valid, float(np.float32(post["nms_thresh"])), d)
    keep &= keep.long().cumsum(1) <= d
    return [(cand[i][keep[i]], top[i][keep[i]], labels[i][keep[i]]) for i in range(b)], floor


@torch.no_grad()
def run(net, frames: Sequence[torch.Tensor], cfg: dict, post: dict,
        fixed: Optional[Tuple[int, int]] = None, chunk: int = 8,
        head_logits: Callable = models.head_logits) -> List[Reference]:
    """The reference of each uint8 HWC frame (on the network's device), in
    chunks of at most ``chunk`` frames of one canvas; ``head_logits`` is
    the reference module's."""
    plans = [plan(tuple(f.shape[:2]), tuple(cfg["size"]), int(cfg["size_divisible"]), fixed)
             for f in frames]
    out: List[Optional[Reference]] = [None] * len(frames)
    by_canvas = {}
    for i, p in enumerate(plans):
        by_canvas.setdefault(p.canvas, []).append(i)
    for canvas, members in by_canvas.items():
        for s in range(0, len(members), chunk):
            ids = members[s:s + chunk]
            x = torch.stack([letterbox(frames[i], plans[i]) for i in ids])
            boxes, scores = decode(head_logits(net, x), cfg["strides"], cfg["anchors"])
            dets, floor = postprocess(boxes, scores, post)
            for j, i in enumerate(ids):
                hw = tuple(frames[i].shape[:2])
                db, ds, dl = dets[j]
                out[i] = Reference(rescale(boxes[j], canvas, hw), scores[j], rescale(db, canvas, hw),
                                   ds, dl, float(floor[j]))
    return out  # type: ignore[return-value]
