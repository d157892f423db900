"""Stream-compaction placement: ``compact_place`` (``csrc/compact_select.cu``)
with its plain PyTorch version.

Replaces ``yolort_tpu/ops/pallas/compact_kernel.py`` (``_compact_kernel``,
the placement step of ``compact_select``): each chunk's gt-tier, then
eq-tier, entries go to their exclusive offsets in lane order.  The op
around it, ``compact_select``, is in ``ops/select.py``.
"""

from __future__ import annotations

import torch

from yolort_tpu_torch.ops.cuda import _build
from yolort_tpu_torch.ops.cuda.lookup_kernel import (
    CHUNK, NO_VALID_BITS, _check_launch, _check_table, _on_cpu,
)


def compact_place_reference(table, cnt, off, t, thr_bits: int, k: int):
    """Plain version: the tier masks of every chunk, their in-lane ranks by
    ``cumsum``, and one ``scatter_`` to off + rank (< k).  Slots nothing
    lands on hold (0.0, 0)."""
    bsz, m, _ = table.shape
    bits = table.contiguous().view(torch.int32)
    tb = t[:, None, None]
    valid = bits > thr_bits
    mask = torch.cat([valid & (bits >= tb + 1), valid & (bits == tb)], dim=1)  # (B, 2m, 128)
    mask &= (cnt > 0)[..., None]
    pos = off[..., None] + mask.to(torch.int32).cumsum(-1) - 1
    keep = mask & (pos < k)
    slot = torch.where(keep, pos, k).long().reshape(bsz, -1)  # slot k collects the rest
    lane_idx = torch.arange(m * CHUNK, dtype=torch.int32, device=table.device).view(m, CHUNK)
    src_v = torch.cat([table, table], dim=1).reshape(bsz, -1)
    src_i = torch.cat([lane_idx, lane_idx]).reshape(1, -1).expand(bsz, -1)
    vals = table.new_zeros(bsz, k + 1).scatter_(1, slot, src_v)
    idx = torch.zeros(bsz, k + 1, dtype=torch.int32, device=table.device).scatter_(1, slot, src_i)
    return vals[:, :k], idx[:, :k]


def compact_place(table: torch.Tensor, cnt: torch.Tensor, off: torch.Tensor, t: torch.Tensor,
                  thr_bits: int, k: int):
    """Place the selected entries at their exclusive offsets.

    table (B, m, 128) f32 scores; cnt, off (B, 2m) i32, the per-chunk tier
    counts and their exclusive offsets over [gt chunks..., eq chunks...];
    t (B,) i32 the k-th value bits; thr_bits the f32 bits of a threshold
    >= 0.  Returns (vals (B, k) f32, idx (B, k) i32 flat indices); slots
    past the selected total hold (0.0, 0).  CUDA tensors launch the kernel
    on the current stream, once, and it writes every slot; CPU tensors take
    ``compact_place_reference``."""
    _check_table(table, "compact_place")
    bsz, m, _ = table.shape
    for name, x in (("cnt", cnt), ("off", off)):
        if x.shape != (bsz, 2 * m) or x.dtype != torch.int32 or x.device != table.device:
            raise ValueError(f"compact_place: {name} must be ({bsz}, {2 * m}) int32 on the table's "
                             f"device, got {tuple(x.shape)} {x.dtype}")
    if t.shape != (bsz,) or t.dtype != torch.int32 or t.device != table.device:
        raise ValueError(f"compact_place: t must be ({bsz},) int32 on the table's device")
    if not 0 <= thr_bits < NO_VALID_BITS:
        raise ValueError(f"thr_bits must be the bits of a threshold in [0, 2), got {thr_bits:#x}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if m * CHUNK >= 2**31:
        raise ValueError("compact_place carries int32 indices: the table is too large")
    if _on_cpu("compact_place", table):
        return compact_place_reference(table, cnt, off, t, thr_bits, k)
    _check_launch("compact_place", table, cnt, off, t)
    # the kernel writes every slot, the empty tail too: one launch a call
    vals = torch.empty(bsz, k, dtype=torch.float32, device=table.device)
    idx = torch.empty(bsz, k, dtype=torch.int32, device=table.device)
    _build.launch(
        compact_place, "yt_compact_place", table, table.data_ptr(), cnt.data_ptr(), off.data_ptr(),
        t.data_ptr(), int(thr_bits), bsz, m, int(k), vals.data_ptr(), idx.data_ptr(),
    )
    return vals, idx


compact_place.launches = 0
