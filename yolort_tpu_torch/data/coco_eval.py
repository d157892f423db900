"""COCO-style mAP evaluation, dependency-free.

Re-design of the reference's ``COCOEvaluator`` (yolort/data/coco_eval.py:28),
which wraps pycocotools' COCOeval.  pycocotools is not in this image, so the
matching + accumulation algorithm is implemented natively in numpy with
COCOeval-compatible semantics:

  * IoU thresholds 0.50:0.05:0.95, recall thresholds 0:0.01:1 (101-point)
  * greedy per-class matching in score order; each GT used once; crowd GTs
    can absorb unlimited detections but never count as matches
  * area ranges all/small/medium/large, maxDets=100 for AP
  * AP = mean over classes present in GT of interpolated precision

Port of ``yolort_tpu/data/coco_eval.py`` (numpy, unchanged but for the
shard merge, which goes through ``torch.distributed``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)  # 10 thresholds
REC_THRS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def box_iou_xyxy(a: np.ndarray, b: np.ndarray, iscrowd: Optional[np.ndarray] = None):
    """IoU matrix (len(a), len(b)); crowd columns use intersection/area_a
    (pycocotools 'iscrowd' semantics)."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float64)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    if iscrowd is not None:
        union = np.where(iscrowd[None, :], area_a[:, None], union)
    return inter / np.maximum(union, 1e-12)


class COCOEvaluator:
    """Accumulates per-image predictions + ground truth, computes COCO AP.

    update() takes plain dicts (no pycocotools index structure needed):
      preds:   {'boxes': (N,4) xyxy, 'scores': (N,), 'labels': (N,)}
      targets: {'boxes': (M,4) xyxy, 'labels': (M,),
                'iscrowd': optional (M,), 'area': optional (M,)}
    """

    def __init__(self, num_classes: Optional[int] = None, max_dets: int = 100):
        self.max_dets = max_dets
        self.num_classes = num_classes
        self._preds: List[Dict] = []
        self._targets: List[Dict] = []

    def reset(self):
        self._preds.clear()
        self._targets.clear()

    def update(self, preds: Sequence[Dict], targets: Sequence[Dict]):
        assert len(preds) == len(targets)
        for p, t in zip(preds, targets):
            self._preds.append({k: np.asarray(v) for k, v in p.items()})
            tt = {k: np.asarray(v) for k, v in t.items()}
            m = len(tt["labels"])
            if "iscrowd" not in tt:
                tt["iscrowd"] = np.zeros(m, bool)
            if "area" not in tt:
                b = tt["boxes"].reshape(m, 4) if m else np.zeros((0, 4))
                tt["area"] = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(
                    b[:, 3] - b[:, 1], 0, None
                )
            self._targets.append(tt)

    # ------------------------------------------------------------------
    # matching (vectorized; pycocotools evaluateImg semantics)
    # ------------------------------------------------------------------
    @staticmethod
    def _greedy_match(ious, g_crowd, g_ignore):
        """Greedy score-order matching, vectorized over all IoU thresholds.

        ious: (n_d, n_g) with detection rows already sorted by descending
        score and GT columns sorted non-ignored-first.  Per pycocotools: a
        detection takes the best *non-ignored* candidate above the threshold
        if one exists, else the best ignored candidate; equal IoUs resolve to
        the later GT (the reference scan updates on >=); crowd GTs can absorb
        unlimited detections.  Returns (matched, match_ignored), both
        (n_iou, n_d) bool."""
        n_d, n_g = ious.shape
        n_t = len(IOU_THRS)
        matched = np.zeros((n_t, n_d), bool)
        match_ig = np.zeros((n_t, n_d), bool)
        if n_d == 0 or n_g == 0:
            return matched, match_ig
        g_used = np.zeros((n_t, n_g), bool)
        ni = ~g_ignore
        rows = np.arange(n_t)
        for di in range(n_d):
            row = ious[di]
            cand = (~g_used) | g_crowd[None, :]  # (n_t, n_g)
            v = np.where(cand, row[None, :], -1.0)
            v_ni = np.where(ni[None, :], v, -1.0)
            b_ni = n_g - 1 - np.argmax(v_ni[:, ::-1], axis=1)  # last max
            ok_ni = v_ni[rows, b_ni] >= IOU_THRS
            v_ig = np.where(g_ignore[None, :], v, -1.0)
            b_ig = n_g - 1 - np.argmax(v_ig[:, ::-1], axis=1)
            ok_ig = (~ok_ni) & (v_ig[rows, b_ig] >= IOU_THRS)
            best = np.where(ok_ni, b_ni, np.where(ok_ig, b_ig, -1))
            hit = best >= 0
            matched[:, di] = hit
            match_ig[:, di] = hit & g_ignore[np.maximum(best, 0)]
            g_used[rows[hit], best[hit]] = True
        return matched, match_ig

    def _evaluate(self, cls_ids):
        """Single pass over images: per-(image, class) IoUs computed ONCE and
        shared across all four area ranges (pycocotools computeIoU caching);
        matching re-runs per range because the GT ignore set differs.

        Returns stats[(cls, area)] = [scores, matched(n_t, n), ignored] and
        n_gt[(cls, area)]."""
        area_items = list(AREA_RANGES.items())
        stats = {(c, a): ([], [], []) for c in cls_ids for a, _ in area_items}
        n_gt = {(c, a): 0 for c in cls_ids for a, _ in area_items}
        cls_set = set(cls_ids)

        for p, t in zip(self._preds, self._targets):
            d_labels = p["labels"].reshape(-1)
            g_labels = t["labels"].reshape(-1)
            present = (set(np.unique(d_labels).tolist())
                       | set(np.unique(g_labels).tolist())) & cls_set
            for cls in present:
                sel_d = d_labels == cls
                d_boxes = p["boxes"].reshape(-1, 4)[sel_d]
                d_scores = p["scores"].reshape(-1)[sel_d]
                order = np.argsort(-d_scores, kind="stable")[: self.max_dets]
                d_boxes, d_scores = d_boxes[order], d_scores[order]
                d_area = np.clip(d_boxes[:, 2] - d_boxes[:, 0], 0, None) * np.clip(
                    d_boxes[:, 3] - d_boxes[:, 1], 0, None
                )

                sel_g = g_labels == cls
                g_boxes = t["boxes"].reshape(-1, 4)[sel_g]
                g_crowd = t["iscrowd"].reshape(-1)[sel_g].astype(bool)
                g_area = t["area"].reshape(-1)[sel_g]
                ious = box_iou_xyxy(d_boxes, g_boxes, iscrowd=g_crowd)  # once per (img, cls)

                for area_name, (lo, hi) in area_items:
                    g_ignore = g_crowd | (g_area < lo) | (g_area > hi)
                    # GT sorted non-ignored first (pycocotools evaluateImg)
                    g_order = np.argsort(g_ignore, kind="stable")
                    m, mig = self._greedy_match(
                        ious[:, g_order], g_crowd[g_order], g_ignore[g_order]
                    )
                    out_of_rng = (d_area < lo) | (d_area > hi)
                    mig = mig | ((~m) & out_of_rng[None, :])
                    s, ms, igs = stats[(cls, area_name)]
                    s.append(d_scores)
                    ms.append(m)
                    igs.append(mig)
                    n_gt[(cls, area_name)] += int((~g_ignore).sum())
        return stats, n_gt

    @staticmethod
    def _accumulate(scores_l, matched_l, ignored_l, n_gt):
        """PR accumulation for one (class, area range): returns (ap, ar) over
        IoU thresholds, or None when the class has no GT in range."""
        n_iou = len(IOU_THRS)
        if n_gt == 0:
            return None
        ap = np.zeros(n_iou)
        ar = np.zeros(n_iou)
        scores = np.concatenate(scores_l) if scores_l else np.zeros(0)
        matched = (np.concatenate(matched_l, axis=1) if matched_l
                   else np.zeros((n_iou, 0), bool))
        ignored = (np.concatenate(ignored_l, axis=1) if ignored_l
                   else np.zeros((n_iou, 0), bool))
        order = np.argsort(-scores, kind="mergesort")
        matched, ignored = matched[:, order], ignored[:, order]
        keep = ~ignored
        for ti in range(n_iou):
            sel = keep[ti]
            tp = np.cumsum(matched[ti][sel])
            fp = np.cumsum(~matched[ti][sel])
            if len(tp) == 0:
                continue
            recall = tp / n_gt
            precision = tp / np.maximum(tp + fp, 1e-12)
            # monotone non-increasing precision envelope
            precision = np.maximum.accumulate(precision[::-1])[::-1]
            # 101-point interpolation
            idx = np.searchsorted(recall, REC_THRS, side="left")
            prec_i = np.where(
                idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0
            )
            ap[ti] = prec_i.mean()
            ar[ti] = recall[-1]
        return ap, ar

    def compute(self) -> Dict[str, float]:
        """Returns the standard COCO metric dict (coco_eval.py:122
        derive_coco_results equivalent, plus per-class AP)."""
        cls_ids = sorted(
            set(
                int(c)
                for t in self._targets
                for c in np.asarray(t["labels"]).reshape(-1).tolist()
            )
        )
        if not cls_ids:
            return {k: float("nan") for k in ("AP", "AP50", "AP75", "APs", "APm", "APl")}

        import warnings

        stats, n_gt = self._evaluate(cls_ids)
        n_iou = len(IOU_THRS)
        ap_by_area = {}
        for area in AREA_RANGES:
            ap_a = np.full((n_iou, len(cls_ids)), np.nan)
            for ci, cls in enumerate(cls_ids):
                acc = self._accumulate(*stats[(cls, area)], n_gt[(cls, area)])
                if acc is not None:
                    ap_a[:, ci] = acc[0]
            ap_by_area[area] = ap_a

        results: Dict[str, float] = {}
        with warnings.catch_warnings():
            # area buckets with no GT legitimately produce all-NaN slices
            warnings.simplefilter("ignore", category=RuntimeWarning)
            ap_all = ap_by_area["all"]
            results["AP"] = float(np.nanmean(ap_all))
            results["AP50"] = float(np.nanmean(ap_all[IOU_THRS == 0.5]))
            results["AP75"] = float(np.nanmean(ap_all[IOU_THRS == 0.75]))
            for name in ("small", "medium", "large"):
                results[f"AP{name[0]}"] = float(np.nanmean(ap_by_area[name]))
            self.per_class_ap = {
                c: float(np.nanmean(ap_all[:, i])) for i, c in enumerate(cls_ids)
            }
        return results

    # ------------------------------------------------------------------
    def synchronize_between_processes(self):
        """Merge every process's shard, in rank order (reference
        coco_eval.py:105-120); one process keeps its own."""
        from yolort_tpu_torch.parallel.distributed import all_gather_objects

        merged = all_gather_objects({"preds": self._preds, "targets": self._targets})
        self._preds = [p for shard in merged for p in shard["preds"]]
        self._targets = [t for shard in merged for t in shard["targets"]]
