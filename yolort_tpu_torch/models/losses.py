"""YOLOv5 training loss, fixed-shape.

Port of ``yolort_tpu/models/losses.py``: CIoU, BCE with logits, label
smoothing, (Q)focal modulation, ``pad_targets`` and ``YOLOLoss``, whose
every stage is a masked fixed-shape computation over targets laid out per
image as (B, T, 5) rows [cls, cx, cy, w, h] (boxes normalised to [0, 1]).

Where torch and JAX differ:
  * ``stop_gradient`` is ``.detach()`` (the CIoU ``alpha`` and the IoU
    objectness target);
  * the candidate gather runs in the head's dtype and casts after
    (``torch.gather`` then ``.float()``), as JAX's ``take_along_axis`` does;
  * the objectness scatter resolves duplicate cells explicitly: two
    candidates on one cell and anchor keep the value of the later one in
    candidate order, which is what JAX's ``.at[idx].set`` gives on the
    CPU.  ``index_put_`` with duplicates is nondeterministic on CUDA, so
    the winner is the largest candidate index of each cell, found by a
    ``scatter_reduce`` amax, and read with a gather;
  * ``clip(x, 0)`` is ``torch.maximum(x, 0)``, whose gradient at the tie
    is split in half as JAX's ``max`` splits it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _relu(x: torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, 0)``: max(x, 0) with JAX's half gradient at the tie."""
    return torch.maximum(x, torch.zeros_like(x))


def bbox_ciou(box1: torch.Tensor, box2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Complete IoU between aligned cxcywh boxes (..., 4)."""
    b1x1, b1x2 = box1[..., 0] - box1[..., 2] / 2, box1[..., 0] + box1[..., 2] / 2
    b1y1, b1y2 = box1[..., 1] - box1[..., 3] / 2, box1[..., 1] + box1[..., 3] / 2
    b2x1, b2x2 = box2[..., 0] - box2[..., 2] / 2, box2[..., 0] + box2[..., 2] / 2
    b2y1, b2y2 = box2[..., 1] - box2[..., 3] / 2, box2[..., 1] + box2[..., 3] / 2

    inter = _relu(torch.minimum(b1x2, b2x2) - torch.maximum(b1x1, b2x1)) * _relu(
        torch.minimum(b1y2, b2y2) - torch.maximum(b1y1, b2y1))
    w1, h1 = b1x2 - b1x1, b1y2 - b1y1 + eps
    w2, h2 = b2x2 - b2x1, b2y2 - b2y1 + eps
    union = w1 * h1 + w2 * h2 - inter + eps
    iou = inter / union

    cw = torch.maximum(b1x2, b2x2) - torch.minimum(b1x1, b2x1)
    ch = torch.maximum(b1y2, b2y2) - torch.minimum(b1y1, b2y1)
    c2 = cw**2 + ch**2 + eps
    rho2 = ((b2x1 + b2x2 - b1x1 - b1x2) ** 2 + (b2y1 + b2y2 - b1y1 - b1y2) ** 2) / 4
    v = (4 / math.pi**2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / (v - iou + (1 + eps))).detach()
    return iou - (rho2 / c2 + v * alpha)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    pos_weight: float = 1.0) -> torch.Tensor:
    """Elementwise binary cross entropy with logits."""
    return -(pos_weight * targets * F.logsigmoid(logits)
             + (1.0 - targets) * F.logsigmoid(-logits))


def smooth_bce_targets(eps: float = 0.0) -> Tuple[float, float]:
    return 1.0 - 0.5 * eps, 0.5 * eps


def focal_modulation(logits: torch.Tensor, targets: torch.Tensor, gamma: float,
                     alpha: float = 0.25, quality: bool = False) -> torch.Tensor:
    """Elementwise focal weight on a BCE-with-logits loss: alpha_factor *
    (1 - p_t)**gamma, or alpha_factor * |true - sigmoid(pred)|**gamma for
    the quality (QFocal) variant."""
    pred_prob = torch.sigmoid(logits)
    alpha_factor = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    if quality:
        modulating = torch.abs(targets - pred_prob) ** gamma
    else:
        p_t = targets * pred_prob + (1.0 - targets) * (1.0 - pred_prob)
        modulating = (1.0 - p_t) ** gamma
    return alpha_factor * modulating


def focal_bce_with_logits(logits, targets, gamma: float, alpha: float = 0.25,
                          pos_weight: float = 1.0, quality: bool = False) -> torch.Tensor:
    """BCE-with-logits modulated by the (Q)focal factor (elementwise)."""
    return bce_with_logits(logits, targets, pos_weight) * focal_modulation(
        logits, targets, gamma, alpha, quality)


def pad_targets(per_image_targets: Sequence[Dict], max_per_image: int,
                device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """List of {'labels': (n,), 'boxes_cxcywh_norm': (n, 4)} numpy dicts ->
    (B, T, 5) [cls, cx, cy, w, h] f32 and (B, T) bool mask on ``device``."""
    b = len(per_image_targets)
    out = np.zeros((b, max_per_image, 5), np.float32)
    mask = np.zeros((b, max_per_image), bool)
    for i, t in enumerate(per_image_targets):
        n = min(len(t["labels"]), max_per_image)
        out[i, :n, 0] = np.asarray(t["labels"][:n])
        out[i, :n, 1:] = np.asarray(t["boxes_cxcywh_norm"][:n])
        mask[i, :n] = True
    return torch.from_numpy(out).to(device), torch.from_numpy(mask).to(device)


def last_write_scatter(idx: torch.Tensor, val: torch.Tensor, size: int) -> torch.Tensor:
    """Per row, zeros(size) with ``val`` written at ``idx`` in order, the
    last write of a duplicate index winning; an index of ``size`` is
    dropped.  idx (B, C) int64, val (B, C) -> (B, size), deterministic."""
    bsz, c = idx.shape
    pos = torch.arange(c, device=idx.device).expand(bsz, c)
    winner = torch.full((bsz, size + 1), -1, dtype=torch.int64, device=idx.device)
    winner.scatter_reduce_(1, idx, pos, "amax", include_self=True)
    winner = winner[:, :size]
    got = torch.gather(val, 1, winner.clamp(min=0))
    return torch.where(winner >= 0, got, torch.zeros_like(got))


@dataclass(frozen=True)
class YOLOLoss:
    """Loss config (the reference's defaults and hyp.scratch.yaml gains)."""

    strides: Tuple[int, ...]
    anchor_grids: Tuple[Tuple[float, ...], ...]
    num_classes: int
    box_gain: float = 0.05
    cls_gain: float = 0.5
    obj_gain: float = 1.0
    cls_pos: float = 1.0
    obj_pos: float = 1.0
    anchor_thresh: float = 4.0
    label_smoothing: float = 0.0
    gr: float = 1.0
    fl_gamma: float = 0.0
    fl_alpha: float = 0.25
    use_qfocal: bool = False

    def _bce(self, logits, targets, pos_weight):
        if self.fl_gamma > 0:
            return focal_bce_with_logits(logits, targets, self.fl_gamma, self.fl_alpha, pos_weight,
                                         quality=self.use_qfocal)
        return bce_with_logits(logits, targets, pos_weight)

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_grids[0]) // 2

    @property
    def balance(self) -> Tuple[float, ...]:
        return (4.0, 1.0, 0.4, 0.1)[: len(self.strides)]

    def _candidates(self, shape, stride: int, ag, targets: torch.Tensor,
                    target_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The candidate lattice of one level of head output ``shape`` (B, H,
        W, ...): per image C = T*5*A candidates, each a target matched to an
        anchor ratio and one of its five neighbour cells.  Returns 'c_mask'
        (B, C) bool, 'cell' (B, C) the flat (H*W*A) index, 'c_txy',
        'c_twh', 'c_anchor_wh' (B, C, 2) and 'c_cls' (B, C)."""
        na = self.num_anchors
        dev = targets.device
        f32 = torch.float32
        bt, nt = targets.shape[:2]
        _, h, w = shape[:3]
        t_cls = targets[..., 0].to(torch.int32)  # (B, T)
        t_xy = targets[..., 1:3]
        t_wh = targets[..., 3:5]
        offsets = torch.tensor([[0, 0], [1, 0], [0, 1], [-1, 0], [0, -1]], dtype=f32,
                               device=dev) * 0.5  # (5, 2)
        anchors = torch.tensor(ag, dtype=f32, device=dev).reshape(na, 2) / stride
        hw = torch.tensor([w, h], dtype=f32, device=dev)
        gxy = t_xy * hw  # (B, T, 2) grid units
        gwh = t_wh * hw

        # anchor-ratio match: (B, T, A)
        r = gwh[:, :, None, :] / anchors[None, None, :, :]
        match = torch.amax(torch.maximum(r, 1.0 / r), dim=-1) < self.anchor_thresh
        match = match & target_mask[:, :, None]

        # neighbour-offset gating: (B, T, 5)
        gx, gy = gxy[..., 0], gxy[..., 1]
        off_ok = torch.stack([
            torch.ones_like(gx, dtype=torch.bool),
            (gx % 1.0 < 0.5) & (gx > 1.0),
            (gy % 1.0 < 0.5) & (gy > 1.0),
            ((w - gx) % 1.0 < 0.5) & ((w - gx) > 1.0),
            ((h - gy) % 1.0 < 0.5) & ((h - gy) > 1.0),
        ], dim=-1)

        # dense candidate lattice (B, T, 5, A), flattened to (B, C)
        cand = off_ok[..., :, None] & match[:, :, None, :]
        gij = torch.floor(gxy[:, :, None, :] - offsets[None, None, :, :])  # (B, T, 5, 2)
        gi = gij[..., 0].to(torch.int32).clamp(0, w - 1)
        gj = gij[..., 1].to(torch.int32).clamp(0, h - 1)

        c = nt * 5 * na
        a_idx = torch.arange(na, device=dev).expand(cand.shape)
        gi_b = gi[..., None].expand(cand.shape)
        gj_b = gj[..., None].expand(cand.shape)
        return {
            "c_mask": cand.reshape(bt, c),
            "cell": ((gj_b * w + gi_b) * na + a_idx).reshape(bt, c).long(),
            "c_txy": (gxy[:, :, None, None, :].expand(*cand.shape, 2)
                      - torch.stack([gi_b, gj_b], dim=-1).to(f32)).reshape(bt, c, 2),
            "c_twh": gwh[:, :, None, None, :].expand(*cand.shape, 2).reshape(bt, c, 2),
            "c_cls": t_cls[:, :, None, None].expand(cand.shape).reshape(bt, c),
            "c_anchor_wh": anchors[a_idx.reshape(bt, c)],
        }

    def __call__(self, head_outputs: Sequence[torch.Tensor], targets: torch.Tensor,
                 target_mask: torch.Tensor, data_axis=None) -> Dict[str, torch.Tensor]:
        """head_outputs: per-level (B, H, W, A*(5+nc)) NHWC logits; targets
        (B, T, 5); target_mask (B, T) bool.  Returns {'cls_logits',
        'bbox_regression', 'objectness'}, f32 scalars.

        ``data_axis`` (a ``parallel.Mesh``): this batch is one of
        ``data_axis.data_size`` equal shards of a global batch.  The box and
        class terms are normalised by each level's candidate count summed
        over the shards (``data_axis.all_sum``), and the objectness mean is
        divided by the number of shards, so that the shards' terms sum to
        the global batch's."""
        na = self.num_anchors
        nc = self.num_classes
        dev = targets.device
        f32 = torch.float32
        smooth_pos, smooth_neg = smooth_bce_targets(self.label_smoothing)
        zero = torch.zeros((), dtype=f32, device=dev)
        loss_box, loss_obj, loss_cls = zero, zero, zero

        levels = [self._candidates(out.shape, stride, ag, targets, target_mask)
                  for out, stride, ag in zip(head_outputs, self.strides, self.anchor_grids)]
        counts = torch.stack([lv["c_mask"].sum() for lv in levels])
        shards = 1
        if data_axis is not None:
            counts = data_axis.all_sum(counts)
            shards = data_axis.data_size

        for out, lv, n_level, bal in zip(head_outputs, levels, counts, self.balance):
            b, h, w, _ = out.shape
            k = 5 + nc
            bt, c = lv["c_mask"].shape
            c_mask, cell = lv["c_mask"], lv["cell"]
            logits = out.reshape(b, h * w * na, k)  # the head's dtype, cast after the gather

            # predictions at the candidate cells, gathered per image
            pred = torch.gather(logits, 1, cell[..., None].expand(bt, c, k)).float()  # (B, C, k)
            sig = torch.sigmoid(pred[..., :4])
            pred_xy = sig[..., :2] * 2.0 - 0.5
            pred_wh = (sig[..., 2:4] * 2.0) ** 2 * lv["c_anchor_wh"]
            pred_box = torch.cat([pred_xy, pred_wh], dim=-1)
            tgt_box = torch.cat([lv["c_txy"], lv["c_twh"]], dim=-1)

            iou = bbox_ciou(pred_box, tgt_box)  # (B, C)
            n_cand = n_level.clamp(min=1)
            loss_box = loss_box + torch.where(c_mask, 1.0 - iou, 0.0).sum() / n_cand

            # objectness: each image's (H*W*A,) grid holds the IoU of the
            # candidate written last on each cell
            score_iou = _relu(iou.detach())
            tobj_val = torch.where(c_mask, (1.0 - self.gr) + self.gr * score_iou, 0.0)
            drop_cell = torch.where(c_mask, cell, h * w * na)
            tobj = last_write_scatter(drop_cell, tobj_val, h * w * na)
            loss_obj_l = torch.mean(self._bce(logits[..., 4].float(), tobj, self.obj_pos))
            loss_obj = loss_obj + loss_obj_l / shards * bal

            if nc > 1:
                onehot = (lv["c_cls"][..., None] == torch.arange(nc, device=dev)).to(f32)
                t = smooth_neg + (smooth_pos - smooth_neg) * onehot
                cls_bce = self._bce(pred[..., 5:], t, self.cls_pos)
                loss_cls = loss_cls + torch.where(c_mask[..., None], cls_bce, 0.0).sum() / (
                    n_cand * nc)

        return {
            "cls_logits": loss_cls * self.cls_gain,
            "bbox_regression": loss_box * self.box_gain,
            "objectness": loss_obj * self.obj_gain,
        }
