"""Plotting utilities: batch mosaics, precision-recall and metric-confidence
curves.

Port of ``yolort_tpu/utils/plots.py``: ``plot_images`` on OpenCV (imported
when it runs), ``plot_pr_curve`` / ``plot_mc_curve`` on matplotlib,
imported inside each function, so a machine without it serves the rest."""

from __future__ import annotations

import math
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np

from yolort_tpu_torch.data.builtin_meta import COCO_CLASSES, class_color
from yolort_tpu_torch.utils.image_utils import plot_one_box


def plot_images(
    images: np.ndarray,
    targets: Optional[np.ndarray] = None,
    paths: Optional[Sequence[str]] = None,
    fname: str = "mosaic.jpg",
    names: Sequence[str] = COCO_CLASSES,
    max_subplots: int = 16,
) -> np.ndarray:
    """Tile a batch into one annotated mosaic image.

    images: (B, H, W, 3) float in [0, 1] or uint8, NHWC.  targets: (N, 6)
    rows [img_idx, cls, cx, cy, w, h] normalized (the training-target
    layout), optional."""
    import cv2

    imgs = np.asarray(images)
    if imgs.dtype != np.uint8:
        imgs = (np.clip(imgs, 0, 1) * 255).astype(np.uint8)
    bs, h, w = imgs.shape[:3]
    bs = min(bs, max_subplots)
    ns = int(math.ceil(bs**0.5))

    mosaic = np.full((ns * h, ns * w, 3), 255, np.uint8)
    for i in range(bs):
        r, c = divmod(i, ns)
        y0, x0 = r * h, c * w
        mosaic[y0 : y0 + h, x0 : x0 + w] = imgs[i]
        if targets is not None and len(targets):
            t = np.asarray(targets)
            rows = t[t[:, 0] == i]
            for row in rows:
                cls = int(row[1])
                cx, cy, bw, bh = row[2] * w, row[3] * h, row[4] * w, row[5] * h
                box = [x0 + cx - bw / 2, y0 + cy - bh / 2, x0 + cx + bw / 2, y0 + cy + bh / 2]
                name = names[cls] if cls < len(names) else str(cls)
                plot_one_box(mosaic, box, color=class_color(cls), label=name)
        if paths:
            cv2.putText(mosaic, str(Path(paths[i]).name)[:40], (x0 + 5, y0 + 20),
                        0, 0.5, (220, 220, 220), 1, cv2.LINE_AA)
    if fname:
        cv2.imwrite(str(fname), cv2.cvtColor(mosaic, cv2.COLOR_RGB2BGR))
    return mosaic


def plot_pr_curve(
    recall_axis: np.ndarray,
    precisions: Dict[str, np.ndarray],
    fname: str = "pr_curve.png",
    title: str = "Precision-Recall",
) -> None:
    """precisions: {label: precision-at-recall_axis}."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    for label, prec in precisions.items():
        ax.plot(recall_axis, prec, linewidth=1.5, label=label)
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.02)
    ax.set_title(title)
    ax.legend(fontsize=8)
    fig.savefig(fname, dpi=150, bbox_inches="tight")
    plt.close(fig)


def plot_mc_curve(
    x: np.ndarray,
    metrics: Dict[str, np.ndarray],
    fname: str = "mc_curve.png",
    xlabel: str = "Confidence",
    ylabel: str = "Metric",
) -> None:
    """Metric-vs-confidence curves (F1/P/R sweeps)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    for label, y in metrics.items():
        ax.plot(x, y, linewidth=1.5, label=label)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1.02)
    ax.legend(fontsize=8)
    fig.savefig(fname, dpi=150, bbox_inches="tight")
    plt.close(fig)
