"""Exact top-k candidate selection on float bit patterns, batched.

Port of ``yolort_tpu/ops/select.py`` for the paths the main program runs:

  * ``_bisect_kth_bits`` — the exact k-th value search (16-ary bisection);
  * ``select_topk_indices`` — the stage-1 anchor screen: the k-th value,
    then one int32 selection over ``tier << B | index`` keys;
  * ``select_topk_threshold`` — the stage-2 pair select, the f32 ``w=128``
    path the JAX package resolves to ``row_gather='pallas_bisect'``: the
    k-th value and per-chunk tier counts from ``bisect_count``, exclusive
    offsets, a slot->chunk lookup, chunk rows from ``row_fetch`` and the
    in-lane extraction tail.

Every function takes a leading batch dimension.  Inputs are scores in
[0, 1] and thresholds >= 0: the domain the kernels' contract covers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from yolort_tpu_torch.ops.cuda.lookup_kernel import NO_VALID_BITS, bisect_count, row_fetch

CHUNK = 128  # stream-compaction chunk width (the JAX w=128 path)


def f32_bits(x: float) -> int:
    """The int32 bit pattern of float32(x)."""
    return int(np.float32(x).view(np.int32))


BISECT_PASSES = 9  # 16-ary passes that shrink the int32 range to a point


def _bisect_kth_bits(bits: torch.Tensor, valid: torch.Tensor, k: int) -> torch.Tensor:
    """Exact k-th largest valid int32 bit pattern per row, (B, n) -> (B,),
    by the branchless 16-ary search of the JAX package: the converged ``lo``
    satisfies count(bits >= lo) >= k > count(bits >= lo + 1), or is the
    smallest valid pattern when fewer than k are valid, or 0x40000000 when
    none is.  int32 arithmetic throughout, as in JAX."""
    if bits.dtype != torch.int32:
        raise ValueError(f"_bisect_kth_bits takes int32 bits, got {bits.dtype}")
    arms = 16
    masked = torch.where(valid, bits, torch.iinfo(torch.int32).min)
    lo = torch.where(valid, bits, NO_VALID_BITS).amin(-1)
    hi = torch.full_like(lo, NO_VALID_BITS)
    for _ in range(BISECT_PASSES):
        step = ((hi - lo) // arms).clamp_min(1)
        m = torch.zeros_like(lo)
        for i in range(1, arms):
            piv = torch.minimum(lo + step * i, hi)
            m += ((masked >= piv[:, None]).sum(-1) >= k).to(torch.int32)
        new_lo = torch.where(m > 0, lo + step * m, lo)
        new_hi = torch.where(m < arms - 1, lo + step * (m + 1), hi)
        lo, hi = new_lo, torch.minimum(new_hi, hi)
    return lo


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
    flat: torch.Tensor, k: int, score_thresh: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k of (B, n) f32 scores > score_thresh, without a sort of
    the domain.  Returns (values (B, k) f32, indices (B, k) int64); empty
    slots hold -1.0 and index 0.  The slots are in descending value order,
    ties in index order (the JAX stable sort of ``sort=True``)."""
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
    s = torch.arange(k, device=flat.device).expand(bsz, k).contiguous()
    # chunk holding output slot s: the last chunk whose offset <= s
    c_of_s = (torch.searchsorted(off, s, right=True) - 1).clamp(0, 2 * m - 1)
    p = s - torch.gather(off, 1, c_of_s)
    phys = c_of_s % m
    is_eq = c_of_s >= m
    rows = row_fetch(table, phys.to(torch.int32))
    return _extract_tail(rows, phys, p, is_eq, t, thr_bits, s, total, k)


def _extract_tail(rows, phys, p, is_eq, t, thr_bits, s, total, k):
    """Recompute the slot's tier on its fetched chunk row, take the p-th
    set lane, mask empty slots, and sort descending."""
    rows_b = rows.view(torch.int32)
    tb = t[:, None, None]
    rows_m = (rows_b > thr_bits) & torch.where(is_eq[..., None], rows_b == tb, rows_b >= tb + 1)
    rank = rows_m.to(torch.int32).cumsum(-1) - 1  # exact in-lane rank
    hit = rows_m & (rank == p[..., None])
    vals = torch.where(hit, rows, 0.0).sum(-1)  # one term per slot: exact
    lane = torch.where(hit, torch.arange(CHUNK, device=rows.device), 0).sum(-1)
    idx = phys * CHUNK + lane
    ok = s < total.clamp(max=k)[:, None]
    vals = torch.where(ok, vals, -1.0)
    idx = torch.where(ok, idx, 0)
    order = torch.sort(-vals, dim=1, stable=True).indices
    return torch.gather(vals, 1, order), torch.gather(idx, 1, order)
