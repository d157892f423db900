"""Anchor-assignment visualization: for each detection level, the GT boxes
and the (cell, anchor) positions the training assigner matches, by the
anchor-ratio and neighbour-offset rule of ``models.losses.YOLOLoss``.

Port of ``yolort_tpu/utils/anchor_viz.py`` on the port's
``image_utils.plot_one_box`` and ``builtin_meta.class_color``."""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from yolort_tpu_torch.data.builtin_meta import class_color
from yolort_tpu_torch.utils.image_utils import plot_one_box


def compute_anchor_matches(
    boxes_cxcywh_norm: np.ndarray,
    strides: Sequence[int],
    anchor_grids: Sequence[Sequence[float]],
    image_hw: Tuple[int, int],
    anchor_thresh: float = 4.0,
) -> List[List[Dict]]:
    """Per level: a list of {'target', 'anchor', 'cell': (gi, gj)} matches."""
    h, w = image_hw
    out = []
    for stride, ag in zip(strides, anchor_grids):
        gh, gw = h // stride, w // stride
        anchors = np.asarray(ag, np.float64).reshape(-1, 2) / stride
        level = []
        for ti, t in enumerate(np.asarray(boxes_cxcywh_norm, np.float64).reshape(-1, 4)):
            gx, gy = t[0] * gw, t[1] * gh
            bw, bh = t[2] * gw, t[3] * gh
            for ai, (aw, ah) in enumerate(anchors):
                r = np.asarray([bw / aw, bh / ah])
                if np.max(np.maximum(r, 1.0 / r)) >= anchor_thresh:
                    continue
                cells = [(int(gx), int(gy))]
                fx, fy = gx % 1.0, gy % 1.0
                if fx < 0.5 and gx > 1.0:
                    cells.append((int(gx) - 1, int(gy)))
                if fy < 0.5 and gy > 1.0:
                    cells.append((int(gx), int(gy) - 1))
                if (gw - gx) % 1.0 < 0.5 and (gw - gx) > 1.0:
                    cells.append((int(gx) + 1, int(gy)))
                if (gh - gy) % 1.0 < 0.5 and (gh - gy) > 1.0:
                    cells.append((int(gx), int(gy) + 1))
                for gi, gj in cells:
                    gi = min(max(gi, 0), gw - 1)
                    gj = min(max(gj, 0), gh - 1)
                    level.append({"target": ti, "anchor": ai, "cell": (gi, gj)})
        out.append(level)
    return out


def anchor_match_visualize(
    image: np.ndarray,
    boxes_cxcywh_norm: np.ndarray,
    labels: np.ndarray,
    strides: Sequence[int],
    anchor_grids: Sequence[Sequence[float]],
    anchor_thresh: float = 4.0,
) -> List[np.ndarray]:
    """One annotated uint8 RGB image per level: the GT boxes and the matched
    cells (each a stride-sized rectangle in its anchor's color)."""
    import cv2

    img_u8 = image if image.dtype == np.uint8 else (np.clip(image, 0, 1) * 255).astype(np.uint8)
    h, w = img_u8.shape[:2]
    matches = compute_anchor_matches(boxes_cxcywh_norm, strides, anchor_grids, (h, w),
                                     anchor_thresh)
    outs = []
    for stride, level in zip(strides, matches):
        canvas = np.ascontiguousarray(img_u8.copy())
        for m in level:
            gi, gj = m["cell"]
            x0, y0 = gi * stride, gj * stride
            cv2.rectangle(canvas, (x0, y0), (x0 + stride, y0 + stride), class_color(m["anchor"]), 1)
        for t, lbl in zip(np.asarray(boxes_cxcywh_norm).reshape(-1, 4), labels):
            cx, cy, bw, bh = t[0] * w, t[1] * h, t[2] * w, t[3] * h
            plot_one_box(canvas, [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2],
                         color=(255, 255, 255), label=str(int(lbl)))
        outs.append(canvas)
    return outs
