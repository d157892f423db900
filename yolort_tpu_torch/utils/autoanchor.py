"""Anchor-fit checking and k-means anchor evolution.

Port of ``yolort_tpu/utils/autoanchor.py`` (numpy only):
``anchor_fitness_metric`` / ``check_anchors`` (best possible recall and
anchors above threshold), ``check_anchor_order``, and ``kmean_anchors``
(Lloyd k-means in log space, then mutation-based evolution), which draws
from ``np.random.default_rng(seed)`` in the JAX package's order, so a
seed gives the same anchors in both packages.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def anchor_fitness_metric(wh: np.ndarray, anchors: np.ndarray, thr: float = 4.0):
    """Best-possible-recall metrics for label wh's against anchors.

    Returns (bpr, aat): fraction of labels with a matching anchor
    (max(r,1/r)<thr) and mean anchors-above-threshold per label."""
    r = wh[:, None, :] / anchors[None, :, :]
    x = np.minimum(r, 1.0 / r).min(axis=2)  # (N, A) worst-side ratio match
    best = x.max(axis=1)
    aat = (x > 1.0 / thr).sum(axis=1).mean()
    bpr = (best > 1.0 / thr).mean()
    return float(bpr), float(aat)


def check_anchor_order(anchor_grids: Sequence[Sequence[float]], strides: Sequence[int]):
    """The anchor grids with their areas ascending with stride: reversed
    where they descend."""
    grids = [np.asarray(a, np.float64).reshape(-1, 2) for a in anchor_grids]
    areas = np.asarray([g.prod(axis=1).mean() for g in grids])
    da = areas[-1] - areas[0]
    ds = strides[-1] - strides[0]
    if np.sign(da) != np.sign(ds):
        grids = grids[::-1]
    return [tuple(g.reshape(-1).tolist()) for g in grids]


def check_anchors(
    label_whs: np.ndarray,
    anchor_grids: Sequence[Sequence[float]],
    thr: float = 4.0,
    imgsz: int = 640,
) -> Tuple[float, float]:
    """(best possible recall, anchors above threshold) of a dataset's label
    sizes against the anchors; label_whs: (N, 2) pixels at train size."""
    anchors = np.concatenate([np.asarray(a, np.float64).reshape(-1, 2) for a in anchor_grids])
    return anchor_fitness_metric(np.asarray(label_whs, np.float64), anchors, thr)


def kmean_anchors(
    label_whs: np.ndarray,
    n: int = 9,
    thr: float = 4.0,
    gen: int = 1000,
    seed: int = 0,
) -> np.ndarray:
    """k-means anchors refined by mutation; label_whs: (N, 2) pixel sizes.
    Returns (n, 2) anchors sorted by area."""
    rng = np.random.default_rng(seed)
    wh = np.asarray(label_whs, np.float64)
    wh = wh[(wh >= 2.0).all(axis=1)]
    if len(wh) < n:
        raise ValueError(f"need at least {n} labels, got {len(wh)}")

    def fitness(anchors):
        r = wh[:, None, :] / anchors[None, :, :]
        x = np.minimum(r, 1.0 / r).min(axis=2).max(axis=1)
        return (x * (x > 1.0 / thr)).mean()

    # Lloyd k-means in log-space (scale-invariant clustering)
    logwh = np.log(wh)
    centers = logwh[rng.choice(len(logwh), n, replace=False)]
    for _ in range(30):
        d = ((logwh[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
        assign = d.argmin(1)
        for ci in range(n):
            sel = assign == ci
            if sel.any():
                centers[ci] = logwh[sel].mean(0)
    anchors = np.exp(centers)

    # genetic evolution: mutate, keep improvements
    best_f = fitness(anchors)
    shape = anchors.shape
    for _ in range(gen):
        mutation = np.ones(shape)
        while (mutation == 1).all():
            mutation = (
                (rng.random(shape) < 0.9) * rng.normal(1, 0.1, shape)
            ).clip(0.3, 3.0)
            mutation[mutation == 0] = 1.0
        cand = (anchors * mutation).clip(min=2.0)
        f = fitness(cand)
        if f > best_f:
            best_f, anchors = f, cand
    return anchors[np.argsort(anchors.prod(1))]
