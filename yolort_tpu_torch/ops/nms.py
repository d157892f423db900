"""Fixed-shape batched postprocess: candidate selection, class-aware
greedy NMS, compaction to padded ``Detections``.

Port of the paths of ``yolort_tpu/ops/nms.py`` the JAX package runs on an
accelerator (``topk_impl='bisect'``, arithmetic anchor properties, Pallas
NMS), with the JAX package's stage-2 axis ``row_gather``
(``'pallas_bisect'``, the default, ``'pallas_lookup'`` or
``'pallas_full'``).  Every route gives the same ``Detections``.

``batched_postprocess_from_heads`` takes the cell-major path
(``flatten_pad='cell'``) unless ``classes_per_anchor`` is set:

  1. stage 1: the ``fused_cells_stage1`` kernel concatenates the head levels
     into the cells table and takes each anchor's max obj and max class
     logit in one pass; their sigmoid product scores the anchors, then the
     top k1 anchors (``select_topk_indices``);
  2. lazy decode of the k1 anchors, then the top k (anchor, class) pairs
     above the score threshold (``select_topk_threshold``, which runs the
     ``bisect_count`` kernel and the ``row_gather`` route's kernels);
  3. the class-offset trick and greedy NMS (the ``nms_mask`` kernel);
  4. compaction of the kept candidates into ``detections_per_img`` slots.

With ``classes_per_anchor`` it takes the flatten path
(``_single_image_nms_from_logits``): the flattened logits' per-anchor
scores, the unsorted top k1 anchors (``select_topk_threshold(sort=False)``),
then, below ``num_classes``, each anchor's best ``classes_per_anchor``
classes as the stage-2 domain.  ``batched_postprocess`` is the
decoded-prediction path (``_single_image_nms``): the same two selections
over (B, Na, 5+nc) decoded predictions.  Both run ``bisect_count``, the
route's fetch kernel and ``nms_mask``, and no stage-1 kernel.

Batch is the leading dimension throughout.  Thresholds are taken as
float32 values, as the JAX program compares them.  Under the profiler
(``utils.profiling``) the spans ``cells`` (the stage-1 table),
``select`` (both selections, to the candidates' gather) and ``nms``
(steps 3 and 4) split the postprocess, and ``candidates`` counts the
pairs that enter NMS.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from yolort_tpu_torch.models.head import anchor_props_from_index, flatten_heads
from yolort_tpu_torch.ops.boxes import cxcywh_to_xyxy
from yolort_tpu_torch.ops.cuda.nms_kernel import nms_mask
from yolort_tpu_torch.ops.cuda.stage1_kernel import fused_cells_stage1
from yolort_tpu_torch.ops.select import ROW_GATHERS, select_topk_indices, select_topk_threshold
from yolort_tpu_torch.utils.profiling import count_later, span

# (boxes (B, k, 4), scores (B, k), labels (B, k) int32, valid (B, k)): the
# selected pairs that enter NMS
Candidates = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _f32(x: float) -> float:
    """x rounded to float32, so a comparison in any precision agrees with
    the float32 comparison of the JAX program."""
    return float(np.float32(x))


def nms_keep_mask(boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
                  tile_size: int = 256, stop_after: int = 0) -> torch.Tensor:
    """Greedy NMS keep mask over score-sorted, class-offset candidates,
    (B, K, 4) + (B, K) -> (B, K) bool: the ``nms_mask`` kernel on the
    card, its plain version on the CPU."""
    return nms_mask(boxes.float().contiguous(), valid.contiguous(), iou_thresh,
                    tile_size=tile_size, stop_after=stop_after)


class Detections(NamedTuple):
    """Padded, fixed-shape detections, batched."""

    boxes: torch.Tensor  # (B, D, 4) xyxy f32
    scores: torch.Tensor  # (B, D) f32
    labels: torch.Tensor  # (B, D) int32
    valid: torch.Tensor  # (B, D) bool
    num: torch.Tensor  # (B,) int32


@dataclass(frozen=True)
class NMSConfig:
    """The postprocess configuration: the semantics axes, the NMS tile and
    the stage-2 implementation axis.

    score_thresh / nms_thresh / detections_per_img: the thresholds;
    pre_nms_topk: the fixed-shape candidate cap k; pre_nms_anchors: the
    stage-1 screen size k1 (None = k + 8, which makes the two-stage
    selection exact); classes_per_anchor: None (exact multi-label
    semantics, the cell path) or each anchor's best C classes as the
    stage-2 domain (the flatten path); nms_tile_size: the granularity of
    the NMS early exit.  row_gather: the stage-2 route of
    ``select_topk_threshold``; the default is the route the JAX package
    resolves to on the TPU; an unknown value raises.
    """

    num_classes: int
    num_anchors: int = 3
    grid_sizes: Tuple[Tuple[int, int], ...] = ()
    strides: Tuple[int, ...] = ()
    anchor_grids: Tuple[Tuple[float, ...], ...] = ()
    score_thresh: float = 0.005
    nms_thresh: float = 0.45
    detections_per_img: int = 300
    pre_nms_topk: int = 4096
    pre_nms_anchors: Optional[int] = None
    classes_per_anchor: Optional[int] = None
    nms_tile_size: int = 256
    row_gather: str = "pallas_bisect"

    def __post_init__(self):
        if self.row_gather not in ROW_GATHERS:
            raise ValueError(f"row_gather must be one of {ROW_GATHERS}, got {self.row_gather!r}")
        if self.classes_per_anchor is not None and self.classes_per_anchor < 1:
            raise ValueError(f"classes_per_anchor must be None or >= 1, got "
                             f"{self.classes_per_anchor}")


def _compact_detections(keep, cand_boxes, top_scores, labels, d: int):
    """Compact kept candidates (score-ordered) into d padded slots; each
    slot receives exactly one candidate, empty slots are zero."""
    bsz = keep.shape[0]
    rank = keep.long().cumsum(1) - 1
    slot = torch.where(keep & (rank < d), rank, d)  # slot d collects the rest
    out_boxes = cand_boxes.new_zeros(bsz, d + 1, 4).scatter_(1, slot[..., None].expand(-1, -1, 4), cand_boxes)
    out_scores = top_scores.new_zeros(bsz, d + 1).scatter_(1, slot, top_scores)
    out_labels = labels.new_zeros(bsz, d + 1).scatter_(1, slot, labels)
    num = keep.sum(1).clamp(max=d).to(torch.int32)
    out_valid = torch.arange(d, device=keep.device)[None, :] < num[:, None]
    return Detections(out_boxes[:, :d], out_scores[:, :d], out_labels[:, :d], out_valid, num)


def _nms_and_compact(cand_boxes, top_scores, labels, valid, *, nms_thresh, detections_per_img,
                     nms_tile_size) -> Detections:
    """Class-offset trick (boxes of different classes never overlap), greedy
    suppression, compaction."""
    with span("nms"):
        max_coord = torch.where(valid[..., None], cand_boxes, 0.0).amax(dim=(1, 2))
        offset_boxes = cand_boxes + (labels.to(cand_boxes.dtype)
                                     * (max_coord[:, None] + 1.0))[..., None]
        keep = nms_keep_mask(offset_boxes, valid, nms_thresh, tile_size=nms_tile_size,
                             stop_after=detections_per_img)
        return _compact_detections(keep, cand_boxes, top_scores, labels, detections_per_img)


def _nms(cands: Candidates, cfg: NMSConfig) -> Detections:
    """NMS and compaction of the candidates under ``cfg``."""
    return _nms_and_compact(*cands, nms_thresh=_f32(cfg.nms_thresh),
                            detections_per_img=cfg.detections_per_img,
                            nms_tile_size=cfg.nms_tile_size)


def _stage1_scores(obj: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """Per-anchor best-class score of the stage-1 maxima (the obj logit and
    the largest class logit, floored at -1e4 as the JAX masked reductions
    floor them): sigmoid(max class logit) * sigmoid(obj logit), in their
    dtype."""
    return torch.sigmoid(cls) * torch.sigmoid(obj)


def _decode_boxes(sel_sig, anchor_sel, cfg: NMSConfig) -> torch.Tensor:
    """xyxy boxes (B, k1, 4) of the selected anchors' sigmoids, anchor
    properties from index arithmetic."""
    g, s, st = anchor_props_from_index(anchor_sel, cfg.grid_sizes, cfg.strides, cfg.anchor_grids)
    xy = (sel_sig[..., 0:2] * 2.0 - 0.5 + g) * st[..., None]
    wh2 = sel_sig[..., 2:4] * 2.0
    wh = wh2 * wh2 * s
    return cxcywh_to_xyxy(torch.cat([xy, wh], dim=-1))


def _stage2_scores(sel_sig, s1_ok, nc: int) -> torch.Tensor:
    """(B, k1, nc) f32 pair scores of the selected anchors; slots past the
    valid-anchor count are 0 and never become candidates."""
    sel_scores = sel_sig[..., 5:5 + nc] * sel_sig[..., 4:5]
    return torch.where(s1_ok[..., None], sel_scores, 0.0)


def _candidates(flat, k: int, row_of, label_of, sel_boxes, cfg: NMSConfig) -> Candidates:
    """Top-k pairs of the (B, n) domain ``flat`` above the score threshold,
    their boxes (``sel_boxes`` rows ``row_of(idx)``) and labels
    (``label_of(idx)``); the valid ones are counted as ``candidates``."""
    score_thresh = _f32(cfg.score_thresh)
    top_scores, top_idx = select_topk_threshold(flat, k, score_thresh, row_gather=cfg.row_gather)
    cand_boxes = torch.gather(sel_boxes, 1, row_of(top_idx)[..., None].expand(-1, -1, 4))
    valid = top_scores > score_thresh
    count_later("candidates", valid)
    return cand_boxes, top_scores, label_of(top_idx).to(torch.int32), valid


def _decode_stage2(sel_sig, anchor_sel, s1_ok, cfg: NMSConfig, k: int, k1: int) -> Candidates:
    """Lazy box decode of the k1 stage-1 anchors and stage-2 pair selection
    over every (anchor, class).  sel_sig (B, k1, 5+nc) f32 sigmoids."""
    nc = cfg.num_classes
    sel_scores = _stage2_scores(sel_sig, s1_ok, nc)
    return _candidates(sel_scores.reshape(sel_scores.shape[0], -1), min(k, k1 * nc),
                       lambda i: i // nc, lambda i: i % nc,
                       _decode_boxes(sel_sig, anchor_sel, cfg), cfg)


def top_classes(sel_scores: torch.Tensor, cpa: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's ``cpa`` largest scores and their classes, (B, k1, cpa)
    each, in ``lax.top_k``'s order: descending, equal scores by the lower
    class first (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    vals, idx = torch.sort(sel_scores, dim=-1, descending=True, stable=True)
    return vals[..., :cpa].contiguous(), idx[..., :cpa].contiguous()


def _stage2_top_classes(sel_sig, anchor_sel, s1_ok, cfg: NMSConfig, k: int, k1: int,
                        cpa: int) -> Candidates:
    """Stage 2 over each selected anchor's best ``cpa`` classes (the
    ``classes_per_anchor`` cut of ``_single_image_nms_from_logits``): the
    (k1 * cpa) domain, in anchor-major order."""
    bsz = sel_sig.shape[0]
    class_vals, class_idx = top_classes(_stage2_scores(sel_sig, s1_ok, cfg.num_classes), cpa)
    class_idx = class_idx.reshape(bsz, -1)
    return _candidates(class_vals.reshape(bsz, -1), min(k, k1 * cpa),
                       lambda i: i // cpa, lambda i: torch.gather(class_idx, 1, i),
                       _decode_boxes(sel_sig, anchor_sel, cfg), cfg)


def _select_cells(cells: torch.Tensor, per_anchor: torch.Tensor, cfg: NMSConfig) -> Candidates:
    """Cell-major lazy-decode selection.  cells: (B, n_cells, A*(5+nc))
    raw logits in conv channel layout, levels concatenated; per_anchor
    (B, n_cells*A), the stage-1 scores."""
    A, nc = cfg.num_anchors, cfg.num_classes
    kw = 5 + nc
    bsz, n_cells, _ = cells.shape
    na = n_cells * A
    k = min(cfg.pre_nms_topk, na * nc)
    k1 = min(cfg.pre_nms_anchors if cfg.pre_nms_anchors is not None else k + 8, na)

    s1_ok, anchor_sel = select_topk_indices(per_anchor.float(), k1)
    # anchor index = cell * A + a, so the (B, na, kw) view holds each
    # anchor's segment as one row
    seg = torch.gather(cells.reshape(bsz, na, kw), 1, anchor_sel[..., None].expand(-1, -1, kw))
    sel_sig = torch.sigmoid(seg.float())
    return _decode_stage2(sel_sig, anchor_sel, s1_ok, cfg, k, k1)


def _select_flatten(logits: torch.Tensor, cfg: NMSConfig) -> Candidates:
    """The flatten-path selection of (B, Na, 5+nc) raw logits in the
    model dtype: per-anchor scores sigmoid(max class logit) *
    sigmoid(obj logit) in that dtype, the top k1 anchors unsorted, their
    rows' f32 sigmoids, then stage 2 over every class, or over each
    anchor's best ``classes_per_anchor`` when that is below
    ``num_classes``."""
    nc = cfg.num_classes
    bsz, na, kw = logits.shape
    k = min(cfg.pre_nms_topk, na * nc)
    k1 = min(cfg.pre_nms_anchors if cfg.pre_nms_anchors is not None else k + 8, na)
    per_anchor = torch.sigmoid(logits[..., 5:5 + nc].amax(-1)) * torch.sigmoid(logits[..., 4])
    s1_vals, anchor_sel = select_topk_threshold(per_anchor.float(), k1, 0.0,
                                                row_gather=cfg.row_gather, sort=False)
    # occupied slots carry a score > 0; the empty ones -1.0 and index 0
    s1_ok = s1_vals >= 0.0
    seg = torch.gather(logits, 1, anchor_sel[..., None].expand(-1, -1, kw))
    sel_sig = torch.sigmoid(seg.float())
    cpa = cfg.classes_per_anchor
    if cpa is None or cpa >= nc:
        return _decode_stage2(sel_sig, anchor_sel, s1_ok, cfg, k, k1)
    return _stage2_top_classes(sel_sig, anchor_sel, s1_ok, cfg, k, k1, cpa)


def batched_postprocess_from_heads(
    head_outputs: Sequence[torch.Tensor],
    strides: Sequence[int],
    anchor_grids: Sequence[Sequence[float]],
    *,
    num_classes: int,
    score_thresh: float = 0.005,
    nms_thresh: float = 0.45,
    detections_per_img: int = 300,
    pre_nms_topk: int = 4096,
    pre_nms_anchors: Optional[int] = None,
    classes_per_anchor: Optional[int] = None,
    nms_tile_size: int = 256,
    row_gather: str = "pallas_bisect",
) -> Detections:
    """Batched postprocess from raw per-level head logits (B, H, W, A*(5+nc)),
    NHWC, in the model dtype (contiguous on the card).  The cell-major path
    when ``classes_per_anchor`` is None, else the flatten path, as the JAX
    package dispatches on an accelerator.  ``row_gather`` picks the
    stage-2 route (``NMSConfig``); the result does not depend on it."""
    cfg = NMSConfig(
        num_classes=num_classes,
        num_anchors=len(anchor_grids[0]) // 2,
        grid_sizes=tuple((int(o.shape[1]), int(o.shape[2])) for o in head_outputs),
        strides=tuple(strides),
        anchor_grids=tuple(tuple(a) for a in anchor_grids),
        score_thresh=score_thresh, nms_thresh=nms_thresh,
        detections_per_img=detections_per_img, pre_nms_topk=pre_nms_topk,
        pre_nms_anchors=pre_nms_anchors, classes_per_anchor=classes_per_anchor,
        nms_tile_size=nms_tile_size, row_gather=row_gather,
    )
    if cfg.classes_per_anchor is not None:
        with span("cells"):
            logits = flatten_heads(head_outputs, cfg.num_anchors)
        with span("select"):
            cands = _select_flatten(logits, cfg)
        return _nms(cands, cfg)
    bsz = head_outputs[0].shape[0]
    with span("cells"):
        cells, obj, cls = fused_cells_stage1(head_outputs, cfg.num_anchors, 5 + num_classes)
        per_anchor = _stage1_scores(obj, cls).reshape(bsz, -1)
    with span("select"):
        cands = _select_cells(cells, per_anchor, cfg)
    return _nms(cands, cfg)


def batched_postprocess(
    pred: torch.Tensor,
    *,
    num_classes: int,
    score_thresh: float = 0.005,
    nms_thresh: float = 0.45,
    detections_per_img: int = 300,
    pre_nms_topk: int = 4096,
    pre_nms_anchors: Optional[int] = None,
    nms_tile_size: int = 256,
    row_gather: str = "pallas_bisect",
) -> Detections:
    """Batched postprocess of decoded predictions (B, Na, 5+nc), columns
    [cx, cy, w, h, obj, cls...] in canvas pixels (``YOLO.decode``): the
    JAX ``_single_image_nms`` with bisect selection.  Stage 1 takes the
    top k1 anchors by best pair score, sorted; stage 2 the top k (anchor,
    class) pairs of those above the score threshold; then NMS and
    compaction.  ``row_gather`` picks both selections' route."""
    cfg = NMSConfig(num_classes=num_classes, score_thresh=score_thresh, nms_thresh=nms_thresh,
                    detections_per_img=detections_per_img, pre_nms_topk=pre_nms_topk,
                    pre_nms_anchors=pre_nms_anchors, nms_tile_size=nms_tile_size,
                    row_gather=row_gather)
    nc = num_classes
    with span("select"):
        pred = pred.float()
        bsz, na, _ = pred.shape
        k = min(pre_nms_topk, na * nc)
        k1 = min(pre_nms_anchors if pre_nms_anchors is not None else k + 8, na)
        boxes_all = cxcywh_to_xyxy(pred[..., :4])
        scores_all = pred[..., 5:5 + nc] * pred[..., 4:5]
        s1_vals, anchor_sel = select_topk_threshold(scores_all.amax(-1), k1, 0.0,
                                                    row_gather=row_gather)
        sel_scores = torch.gather(scores_all, 1, anchor_sel[..., None].expand(-1, -1, nc))
        sel_scores = torch.where(s1_vals[..., None] >= 0.0, sel_scores, 0.0)
        cands = _candidates(sel_scores.reshape(bsz, -1), min(k, k1 * nc),
                            lambda i: torch.gather(anchor_sel, 1, i // nc), lambda i: i % nc,
                            boxes_all, cfg)
    return _nms(cands, cfg)
