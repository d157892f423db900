"""Detection metrics: per-class AP, confusion matrix, fitness.

Port of ``yolort_tpu/utils/metrics.py`` (the reference's
yolort/v5/utils/metrics.py: ap_per_class:21, compute_ap:88,
ConfusionMatrix:124, fitness:15), a numpy copy: the YOLOv5-style metrics
beside the COCO-protocol evaluator of ``data.coco_eval``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from yolort_tpu_torch.utils.boxes import box_iou


def fitness(metrics: np.ndarray) -> np.ndarray:
    """Weighted model fitness: 0.1*mAP@.5 + 0.9*mAP@.5:.95 over columns
    [P, R, mAP@.5, mAP@.5:.95] (reference metrics.py:15)."""
    w = np.asarray([0.0, 0.0, 0.1, 0.9])
    return (np.asarray(metrics)[..., :4] * w).sum(-1)


def compute_ap(recall, precision) -> Tuple[float, np.ndarray, np.ndarray]:
    """AP from raw recall/precision curves via 101-point interpolation.

    Returns (ap, envelope precision, padded recall)."""
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    mpre = np.flip(np.maximum.accumulate(np.flip(mpre)))
    x = np.linspace(0, 1, 101)
    ap = np.trapezoid(np.interp(x, mrec, mpre), x) if hasattr(np, "trapezoid") else np.trapz(
        np.interp(x, mrec, mpre), x
    )
    return float(ap), mpre, mrec


def ap_per_class(tp, conf, pred_cls, target_cls, eps: float = 1e-16) -> Dict[str, np.ndarray]:
    """Per-class P/R/AP from accumulated statistics.

    tp: (N, n_iou) bool — detection true-positive flags per IoU threshold
    conf: (N,) scores; pred_cls: (N,); target_cls: (M,) all GT classes.
    Returns dict with p, r, ap (nc, n_iou), f1, classes.
    """
    tp, conf, pred_cls, target_cls = map(np.asarray, (tp, conf, pred_cls, target_cls))
    order = np.argsort(-conf, kind="mergesort")
    tp, conf, pred_cls = tp[order], conf[order], pred_cls[order]

    classes, n_gt = np.unique(target_cls, return_counts=True)
    nc = len(classes)
    n_iou = tp.shape[1] if tp.ndim > 1 else 1
    tp = tp.reshape(len(tp), n_iou)

    ap = np.zeros((nc, n_iou))
    # per-class P/R curves interpolated onto one common confidence axis, so
    # every class is reported at a single global operating point (reference
    # v5/utils/metrics.py ap_per_class: px=linspace(0,1,1000), i=f1.mean(0).argmax())
    px = np.linspace(0, 1, 1000)
    p_curve = np.zeros((nc, len(px)))
    r_curve = np.zeros((nc, len(px)))
    for ci, c in enumerate(classes):
        sel = pred_cls == c
        n_p = int(sel.sum())
        if n_p == 0 or n_gt[ci] == 0:
            continue
        fpc = np.cumsum(~tp[sel], axis=0)
        tpc = np.cumsum(tp[sel], axis=0)
        recall = tpc / (n_gt[ci] + eps)
        precision = tpc / (tpc + fpc)
        r_curve[ci] = np.interp(-px, -conf[sel], recall[:, 0], left=0)
        p_curve[ci] = np.interp(-px, -conf[sel], precision[:, 0], left=1)
        for ti in range(n_iou):
            ap[ci, ti], _, _ = compute_ap(recall[:, ti], precision[:, ti])

    f1_curve = 2 * p_curve * r_curve / (p_curve + r_curve + eps)
    best = int(np.argmax(f1_curve.mean(0)))
    p_out, r_out, f1 = p_curve[:, best], r_curve[:, best], f1_curve[:, best]
    return {"p": p_out, "r": r_out, "ap": ap, "f1": f1, "classes": classes,
            "p_curve": p_curve, "r_curve": r_curve, "f1_curve": f1_curve, "px": px}


class ConfusionMatrix:
    """Detection confusion matrix (reference metrics.py:124): class
    (nc+1, nc+1) counts with a background row/col for FP/FN."""

    def __init__(self, nc: int, conf: float = 0.25, iou_thres: float = 0.45):
        self.nc = nc
        self.conf = conf
        self.iou_thres = iou_thres
        self.matrix = np.zeros((nc + 1, nc + 1), np.int64)

    def process_batch(self, detections, labels):
        """detections: (N, 6) [x1,y1,x2,y2,conf,cls]; labels: (M, 5)
        [cls,x1,y1,x2,y2]."""
        detections = np.asarray(detections, np.float64).reshape(-1, 6)
        labels = np.asarray(labels, np.float64).reshape(-1, 5)
        detections = detections[detections[:, 4] > self.conf]
        gt_cls = labels[:, 0].astype(int)
        det_cls = detections[:, 5].astype(int)

        if len(labels) and len(detections):
            iou = box_iou(labels[:, 1:5], detections[:, :4])
            pairs = np.argwhere(iou > self.iou_thres)
            if len(pairs):
                vals = iou[pairs[:, 0], pairs[:, 1]]
                order = np.argsort(-vals)
                pairs = pairs[order]
                # unique per detection then per GT (best IoU wins)
                pairs = pairs[np.unique(pairs[:, 1], return_index=True)[1]]
                pairs = pairs[np.argsort(-iou[pairs[:, 0], pairs[:, 1]])]
                pairs = pairs[np.unique(pairs[:, 0], return_index=True)[1]]
            matched_gt = set(pairs[:, 0].tolist()) if len(pairs) else set()
            matched_det = set(pairs[:, 1].tolist()) if len(pairs) else set()
            for g, d in pairs if len(pairs) else []:
                self.matrix[det_cls[d], gt_cls[g]] += 1
        else:
            pairs = np.zeros((0, 2), int)
            matched_gt, matched_det = set(), set()

        for g in range(len(labels)):
            if g not in matched_gt:
                self.matrix[self.nc, gt_cls[g]] += 1  # background FN
        for d in range(len(detections)):
            if d not in matched_det:
                self.matrix[det_cls[d], self.nc] += 1  # background FP

    def tp_fp(self):
        tp = self.matrix.diagonal()[: self.nc]
        fp = self.matrix.sum(1)[: self.nc] - tp
        return tp, fp
