"""The comparison that decides ``correct``: the program's detections of a
frame, as ``__call__`` returned them, held against the plain reference
of the same frame and weights (``reference.pipeline``).

The numbers, over every judged frame:

* ``score_err``: each program detection is matched to the reference pair
  (an anchor, the detection's label) nearest to it: the least sum of the
  box gap (the largest |coordinate gap| over the reference box's longer
  side, at least 8 pixels) and the |score gap|.  The largest |score gap|
  of a matched pair.  A wrong label, a wrong score or a detection the
  network never produced reads large; a right one reads at most its own
  errors, whichever neighbouring anchor of a near-alike box it is
  matched to.
* ``box_err``: the largest box gap of the same matched pairs (a fraction
  of the box's size).
* ``score_err_p50``, ``box_err_p50``: the median gaps of the matched pairs
  over every judged detection: steady from seed to seed where a lower
  precision spreads the largest gap wide.
* ``frame_score_p90``: the 90th percentile, over the judged frames, of a
  frame's median score gap: one frame a call answered wrongly as a whole
  (another slot's answer: an eighth of the frames of a call of 8) reads
  large, where a lower precision's rare odd frame does not.
* ``miss_gap``: for each reference detection, how far its score lies
  above the best reason the program may have had to leave it out: a
  program detection of its label overlapping it by IoU above
  ``nms_thresh - iou_slack``, or of a box within ``iou_slack`` of its
  size (the program kept that one instead, or suppressed it by that one;
  a box of no area has no IoU), the lowest kept score when the program
  returned ``detections_per_img`` detections, the reference's top-k
  floor, the score threshold.  A greedy NMS on scores within e of the
  reference's reads at most 2e, whatever near-ties it broke otherwise; a
  frame left out, or a detection dropped, reads its score.
* ``bad_frames``: the share of judged frames, in %, with a detection whose
  score gap exceeds ``bad_score``, or whose box gap exceeds ``bad_box``,
  or a reference detection whose miss gap exceeds ``bad_score`` (both
  tolerances in the cell's limits file): one detection altered, dropped
  or made up in each frame reads 100, where a lower precision's rare
  wide gaps touch a few frames.
* ``lost_frames``: judged frames for which the program returned nothing
  while the reference kept a detection ``LOST_MARGIN`` above the score
  threshold; an exact count.
* ``overlap_excess``: the largest IoU above ``nms_thresh`` between two
  program detections of one label: a greedy NMS keeps none such.

Limits come from ``limits/<cell>.json``, which names the numbers the
cell compares, beside the readings they were set from (``PERF.md``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference.pipeline import Reference, box_iou

NUMBERS = ("score_err", "box_err", "score_err_p50", "box_err_p50", "frame_score_p90", "miss_gap",
           "bad_frames", "lost_frames", "overlap_excess")
# a frame counts as lost where the program returned nothing and the
# reference kept a detection this far above the score threshold
LOST_MARGIN = 0.05


def judge_frame(out: Dict[str, np.ndarray], ref: Reference, post: dict, iou_slack: float,
                device) -> Dict[str, object]:
    """One frame's readings: the matched gaps of every program detection
    and the miss gap of every reference detection (arrays), the lost flag
    and the overlap excess."""
    boxes = torch.as_tensor(np.asarray(out["boxes"], np.float32), device=device).reshape(-1, 4)
    scores = torch.as_tensor(np.asarray(out["scores"], np.float32), device=device).reshape(-1)
    labels = torch.as_tensor(np.asarray(out["labels"], np.int64), device=device).reshape(-1)
    nms_thr = float(np.float32(post["nms_thresh"]))
    thr = float(np.float32(post["score_thresh"]))
    res = {"score_gaps": np.zeros(0), "box_gaps": np.zeros(0), "miss_gaps": np.zeros(0),
           "overlap_excess": 0.0,
           "lost_frames": float(n_lost(boxes.shape[0], ref, thr))}
    n = boxes.shape[0]
    if n:
        if int(labels.min()) < 0 or int(labels.max()) >= ref.scores.shape[1]:
            inf = np.full(n, np.inf)
            return {**res, "score_gaps": inf, "box_gaps": inf}
        side = (ref.boxes[:, 2:] - ref.boxes[:, :2]).amax(-1).clamp(min=8.0)   # (N,)
        dbox = (ref.boxes[None, :, :] - boxes[:, None, :]).abs().amax(-1) / side  # (n, N)
        dscore = (ref.scores[:, labels].T - scores[:, None]).abs()              # (n, N)
        a = torch.argmin(dbox + dscore, dim=1)
        rows = torch.arange(n, device=device)
        res["box_gaps"] = dbox[rows, a].double().cpu().numpy()
        res["score_gaps"] = dscore[rows, a].double().cpu().numpy()
        same = labels[:, None] == labels[None, :]
        iou = torch.where(same & ~torch.eye(n, dtype=torch.bool, device=device),
                          box_iou(boxes, boxes).nan_to_num(0.0), torch.zeros((), device=device))
        res["overlap_excess"] = max(0.0, float(iou.max()) - nms_thr)
    if ref.det_scores.numel():
        floor = max(ref.topk_floor, thr)
        if n >= int(post["detections_per_img"]):
            floor = max(floor, float(scores.min()))
        reason = torch.full_like(ref.det_scores, floor)
        if n:
            iou = box_iou(ref.det_boxes, boxes)
            side = (ref.det_boxes[:, 2:] - ref.det_boxes[:, :2]).amax(-1).clamp(min=8.0)
            alike = (ref.det_boxes[:, None, :] - boxes[None, :, :]).abs().amax(-1) / side[:, None]
            # a box of no area has no IoU (0 / 0): the same box covers it
            cover = (((iou > nms_thr - iou_slack) | (alike <= iou_slack))
                     & (ref.det_labels[:, None] == labels[None, :]))
            best = torch.where(cover, scores[None, :], torch.full_like(iou, -1.0)).amax(1)
            reason = torch.maximum(reason, best)
        res["miss_gaps"] = (ref.det_scores - reason).clamp(min=0.0).double().cpu().numpy()
    return res


def n_lost(n_program: int, ref: Reference, thr: float) -> int:
    return int(n_program == 0 and bool((ref.det_scores > thr + LOST_MARGIN).any()))


def _top(v: np.ndarray) -> float:
    return float(v.max()) if v.size else 0.0


def _mid(v: np.ndarray) -> float:
    return float(np.median(v)) if v.size else 0.0


class Tally:
    """The numbers over every judged frame (the module's docstring).
    ``bad_score`` and ``bad_box`` are the tolerances of ``bad_frames``."""

    def __init__(self, bad_score: float = float("inf"), bad_box: float = float("inf")):
        self.bad_score, self.bad_box = bad_score, bad_box
        self.score, self.box, self.frames = [], [], []
        self.miss = self.overlap = 0.0
        self.lost = self.bad = 0

    def add(self, frame: Dict[str, object]) -> None:
        sc, bx, ms = frame["score_gaps"], frame["box_gaps"], frame["miss_gaps"]
        self.score.append(sc)
        self.box.append(bx)
        self.miss = max(self.miss, _top(ms))
        self.overlap = max(self.overlap, frame["overlap_excess"])
        self.lost += int(frame["lost_frames"])
        self.bad += int(_top(sc) > self.bad_score or _top(bx) > self.bad_box
                        or _top(ms) > self.bad_score)
        # (largest score, box and miss gap, median score and box gap, detections) of the frame
        self.frames.append((_top(sc), _top(bx), _top(ms), _mid(sc), _mid(bx), int(sc.size)))

    def numbers(self) -> Dict[str, float]:
        sc = np.concatenate(self.score) if self.score else np.zeros(0)
        bx = np.concatenate(self.box) if self.box else np.zeros(0)
        fr = np.asarray(self.frames, np.float64).reshape(-1, 6)
        return {"score_err": _top(sc), "box_err": _top(bx), "score_err_p50": _mid(sc),
                "box_err_p50": _mid(bx),
                "frame_score_p90": float(np.percentile(fr[:, 3], 90)) if len(fr) else 0.0,
                "miss_gap": self.miss,
                "bad_frames": 100.0 * self.bad / max(1, len(self.frames)),
                "lost_frames": float(self.lost), "overlap_excess": self.overlap}


def judge(outputs: Sequence[Dict[str, np.ndarray]], refs: Sequence[Reference], post: dict,
          iou_slack: float, device, tally: Tally = None) -> Tally:
    """Add every frame of one call to ``tally`` (a new one by default)."""
    tally = Tally() if tally is None else tally
    for out, ref in zip(outputs, refs):
        tally.add(judge_frame(out, ref, post, iou_slack, device))
    return tally


def verdict(worst: Dict[str, float], limits: Dict[str, float]) -> List[tuple]:
    """(name, value, limit, within) for each number the cell's limits name:
    a number is compared only where its limit could be set between the
    program's readings and its control's."""
    return [(k, worst[k], float(limits[k]), bool(worst[k] <= float(limits[k])))
            for k in NUMBERS if k in limits]
