"""Exact top-k candidate selection on float bit patterns, batched.

Port of ``yolort_tpu/ops/select.py`` for the paths the main program runs:

  * ``_bisect_kth_bits`` — the exact k-th value search (16-ary bisection),
    from ``ops/cuda/lookup_kernel.py``, where ``bisect_count``'s plain
    version uses it;
  * ``select_topk_indices`` — the stage-1 anchor screen: the k-th value,
    then one int32 selection over ``tier << B | index`` keys;
  * ``select_topk_indices_compact`` — the same (ok, idx) contract through
    ``select_topk_threshold(sort=False)``;
  * ``select_topk_threshold`` — the stage-2 pair select, the f32 ``w=128``
    path: the k-th value and per-chunk tier counts from ``bisect_count``,
    exclusive offsets, then one of three ``row_gather`` routes (the JAX
    package's names): ``'pallas_bisect'`` (the default) a slot->chunk
    lookup, chunk rows from ``row_fetch`` and the in-lane extraction tail;
    ``'pallas_lookup'`` the lookup and the fetch in ``lookup_fetch``, then
    the tail; ``'pallas_full'`` the lookup, then fetch and extraction in
    ``select_extract``.  All three return the same values and indices;
  * ``compact_select`` — the same exact top-k by stream compaction
    (``compact_place``), the counterpart of
    ``yolort_tpu/ops/pallas/compact_kernel.py:compact_select``.

Every function takes a leading batch dimension.  Inputs are scores in
[0, 1] and thresholds >= 0: the domain the kernels' contract covers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from yolort_tpu_torch.ops.cuda.compact_kernel import compact_place
from yolort_tpu_torch.ops.cuda.lookup_kernel import (
    CHUNK, bisect_count, extract_hits, lookup_fetch, row_fetch, select_extract,
)
from yolort_tpu_torch.ops.cuda.lookup_kernel import BISECT_PASSES, _bisect_kth_bits  # noqa: F401

ROW_GATHERS = ("pallas_bisect", "pallas_lookup", "pallas_full")


def f32_bits(x: float) -> int:
    """The int32 bit pattern of float32(x)."""
    return int(np.float32(x).view(np.int32))


def _chunk_table(flat: torch.Tensor) -> torch.Tensor:
    """(B, n) f32 -> (B, ceil(n/128), 128), zero-padded (zeros never pass a
    threshold >= 0)."""
    pad = (-flat.shape[1]) % CHUNK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(flat.shape[0], pad)], dim=1)
    return flat.reshape(flat.shape[0], -1, CHUNK).contiguous()


def select_topk_indices(
    flat: torch.Tensor, k: int, score_thresh: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Indices-only exact top-k of (B, n) f32 scores above score_thresh.

    Returns (ok (B, k) bool, idx (B, k) int64): strictly-above entries
    first, then boundary ties, each in index order; ``ok`` marks occupied
    slots (unoccupied slots carry an unspecified index).  The k-th value
    comes from ``bisect_count`` over the zero-padded chunk table."""
    bsz, n = flat.shape
    k = min(k, n)
    flat = flat.float()
    thr_bits = f32_bits(score_thresh)
    t, _, _ = bisect_count(_chunk_table(flat), k, thr_bits)
    bits = flat.contiguous().view(torch.int32)
    valid = bits > thr_bits
    tier = torch.where(
        valid & (bits >= t[:, None] + 1), 0, torch.where(valid & (bits == t[:, None]), 1, 2)
    ).to(torch.int32)
    shift = max(int(n - 1).bit_length(), 1)
    iota = torch.arange(n, dtype=torch.int32, device=flat.device)
    key = (tier << shift) | iota
    skey = torch.topk(key, k, dim=1, largest=False, sorted=True).values  # keys are unique
    idx = (skey & ((1 << shift) - 1)).long()
    total = (tier < 2).sum(-1)
    ok = torch.arange(k, device=flat.device)[None, :] < total.clamp(max=k)[:, None]
    return ok, idx


def select_topk_threshold(
    flat: torch.Tensor, k: int, score_thresh: float, row_gather: str = "pallas_bisect",
    sort: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of (B, n) f32 scores > score_thresh, without a sort of
    the domain.  Returns (values (B, k) f32, indices (B, k) int64); empty
    slots hold -1.0 and index 0.  With ``sort`` the slots are in
    descending value order, ties in index order (the JAX stable sort);
    without, the strictly-above entries in index order, then the boundary
    ties in index order (the JAX ``sort=False`` order).  ``row_gather``
    picks the route (module docstring); every route gives the same
    result."""
    if row_gather not in ROW_GATHERS:
        raise ValueError(f"row_gather must be one of {ROW_GATHERS}, got {row_gather!r}")
    bsz, n = flat.shape
    k = min(k, n)
    table = _chunk_table(flat.float())
    m = table.shape[1]
    thr_bits = f32_bits(score_thresh)
    t, cnt_gt, cnt_eq = bisect_count(table, k, thr_bits)
    # virtual concatenation [gt entries, eq entries], both in index order
    cnt = torch.cat([cnt_gt, cnt_eq], dim=1).long()
    off = cnt.cumsum(1) - cnt
    total = off[:, -1] + cnt[:, -1]
    if row_gather == "pallas_lookup":
        rows, phys, p, is_eq = lookup_fetch(table, off.to(torch.int32), k)
        return _extract_tail(rows, phys, p, is_eq, t, thr_bits, total, k, sort)
    s = torch.arange(k, device=flat.device).expand(bsz, k).contiguous()
    # chunk holding output slot s: the last chunk whose offset <= s
    c_of_s = (torch.searchsorted(off, s, right=True) - 1).clamp(0, 2 * m - 1)
    p = s - torch.gather(off, 1, c_of_s)
    phys = c_of_s % m
    is_eq = c_of_s >= m
    if row_gather == "pallas_full":
        vals, lane = select_extract(table, phys.to(torch.int32), p.to(torch.int32), is_eq, t,
                                    thr_bits)
        return _mask_and_sort(vals, phys * CHUNK + lane, total, k, sort)
    rows = row_fetch(table, phys.to(torch.int32))
    return _extract_tail(rows, phys, p, is_eq, t, thr_bits, total, k, sort)


def select_topk_indices_compact(
    flat: torch.Tensor, k: int, score_thresh: float = 0.0, row_gather: str = "pallas_bisect"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``select_topk_indices``'s (ok, idx) contract through the stage-2
    machinery (``select_topk_threshold(sort=False)`` on ``row_gather``'s
    route): strictly-above entries, then boundary ties, each in index
    order; ``ok`` marks the occupied slots, whose value exceeds
    ``score_thresh`` (empty slots hold -1.0 and index 0)."""
    vals, idx = select_topk_threshold(flat.float(), k, score_thresh, row_gather=row_gather,
                                      sort=False)
    return vals > float(np.float32(score_thresh)), idx


def _extract_tail(rows, phys, p, is_eq, t, thr_bits, total, k, sort=True):
    """Recompute the slot's tier on its fetched chunk row, take the p-th
    set lane, mask empty slots, and (``sort``) sort descending."""
    vals, lane = extract_hits(rows, p, is_eq, t, thr_bits)
    return _mask_and_sort(vals, phys.long() * CHUNK + lane, total, k, sort)


def _mask_and_sort(vals, idx, total, k, sort: bool = True):
    """Slots at or past min(total, k) become (-1.0, 0); then, if ``sort``,
    the stable descending sort of the values (ties keep slot order)."""
    ok = torch.arange(k, device=vals.device)[None, :] < total.clamp(max=k)[:, None]
    vals = torch.where(ok, vals, -1.0)
    idx = torch.where(ok, idx.long(), 0)
    if not sort:
        return vals, idx
    order = torch.sort(-vals, dim=1, stable=True).indices
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)


def compact_select(
    flat: torch.Tensor, k: int, score_thresh: float, sort: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of (B, n) f32 scores > score_thresh by stream
    compaction: t and the per-chunk tier counts from ``bisect_count`` (the
    fixed point the JAX bisection reaches), their exclusive offsets over
    [gt chunks..., eq chunks...], then ``compact_place``.  Returns (values
    (B, k) f32, indices (B, k) int64), empty slots -1.0 and index 0; with
    ``sort`` in descending value order, ties in index order (the result of
    ``select_topk_threshold``), else strictly-above entries then ties, each
    in index order."""
    k = min(k, flat.shape[1])
    table = _chunk_table(flat.float())
    thr_bits = f32_bits(score_thresh)
    t, cnt_gt, cnt_eq = bisect_count(table, k, thr_bits)
    cnt = torch.cat([cnt_gt, cnt_eq], dim=1)
    off = cnt.cumsum(1, dtype=torch.int32) - cnt
    total = off[:, -1] + cnt[:, -1]
    vals, idx = compact_place(table, cnt, off, t, thr_bits, k)
    return _mask_and_sort(vals, idx, total, k, sort)
