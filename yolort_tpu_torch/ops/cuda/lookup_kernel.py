"""Stage-2 selection kernels, each with its plain PyTorch version:
``bisect_count`` (``csrc/bisect_count.cu``), ``row_fetch`` and
``row_fetch_p`` (``csrc/row_fetch.cu``), ``lookup_fetch`` and
``lookup_fetch_variant`` (``csrc/lookup_fetch.cu``) and ``select_extract``
(``csrc/select_extract.cu``).

Replace ``yolort_tpu/ops/pallas/lookup_kernel.py``: ``_bisect_count_kernel``
/ ``pallas_bisect_count``, ``_fetch_kernel`` + ``_fetch_block_bits`` /
``pallas_row_fetch``, ``_lookup_fetch_kernel`` / ``pallas_lookup_fetch``
and ``_select_kernel`` / ``pallas_select_extract``; and the timing kernels
of ``tools/experiments``: ``fetch_block_sweep.py`` (``row_fetch_p``, the
row fetch at a swept geometry) and ``lookup_kernel_variants.py``
(``run_variant``, stripped variants of the lookup-fetch).  The TPU kernels keep
the chunk table in VMEM and fetch rows with byte-plane one-hot matmuls to
dodge the TPU's slow gathers; on the H100 the first is a radix select over
the bit patterns by a thread-block cluster per image (``bisect_plan``) and
the others read rows directly (the source notes say how, and what bounds
each).  All are batched over a leading image
dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from yolort_tpu_torch.ops.cuda import _build
from yolort_tpu_torch.ops.library import register

CHUNK = 128  # chunk-table row width

# bits of 2.0f: the k-th value when no entry is valid (and the bisection's
# upper bound; valid scores sit below it)
NO_VALID_BITS = 0x40000000
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


def bisect_count_reference(table: torch.Tensor, k: int, thr_bits: int):
    """Plain version: table (B, m, 128) f32 -> t (B,) i32, the k-th largest
    valid bit pattern (valid = bits > thr_bits) as ``_bisect_kth_bits``
    defines it, and the per-chunk counts cnt_gt (B, m) of valid bits >= t+1
    and cnt_eq (B, m) of valid bits == t, both i32."""
    bsz = table.shape[0]
    bits = table.contiguous().view(torch.int32)
    valid = bits > thr_bits
    t = _bisect_kth_bits(bits.reshape(bsz, -1), valid.reshape(bsz, -1), k)
    tb = t[:, None, None]
    gt = valid & (bits >= tb + 1)  # int32 wrap-around, as in JAX
    eq = valid & (bits == tb)
    return t, gt.sum(-1, dtype=torch.int32), eq.sum(-1, dtype=torch.int32)


# bisect_count's launch plan: a cluster of blocks per image, each block on
# a contiguous run of whole rows, held in its shared memory when that pays.
# A resident block takes at most 100 KB of rows: with the kernel's static
# part (~3 KB) and the 1 KB the runtime keeps per block, two blocks share
# an H100 SM's 228 KB, so a 16-block cluster needs 8 SMs of a GPC, not 16.
# This is the one budget: the C side sets a launch's shared memory to what
# the launch asks for and the runtime refuses what does not fit.
BISECT_SMEM_BYTES = 100 * 1024
ROW_BYTES = CHUNK * 4


class BisectPlan(NamedTuple):
    cluster: int  # blocks per image, 2-16
    resident: bool  # each block's rows held in shared memory


def bisect_plan(bsz: int, m: int) -> BisectPlan:
    """The cluster size and mode of the ``bisect_count`` kernel for a
    (bsz, m, 128) table.  8 blocks an image while that gives a block at
    most 64 rows (m <= 512), else 16: each pass pays a cluster barrier,
    and more blocks only pay where the rows are many; never more blocks
    than rows, never fewer than 2.  Resident (each block's rows read from
    device memory once, into shared memory) when a block's rows fit in
    ``BISECT_SMEM_BYTES``, half an SM, else streamed on each pass: from
    3,201 rows at 16 blocks."""
    if not 1 <= bsz <= 65535 or m < 1:
        raise ValueError(f"bisect_plan needs 1-65535 images and a row, got ({bsz}, {m})")
    cluster = max(2, min(8 if m <= 8 * 64 else 16, m))
    return BisectPlan(cluster, -(-m // cluster) * ROW_BYTES <= BISECT_SMEM_BYTES)


def _on_cpu(name: str, table: torch.Tensor) -> bool:
    """True for a CPU table, False for a CUDA one; any other device raises."""
    if table.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {table.device}")
    return table.device.type == "cpu"


def _check_launch(name: str, table: torch.Tensor, *others: torch.Tensor) -> None:
    """A launch's own checks, made in the CUDA implementation, which an
    exported program calls without the wrapper: contiguous inputs and a
    16-byte aligned table."""
    if not (table.is_contiguous() and all(x.is_contiguous() for x in others)):
        raise ValueError(f"{name} needs contiguous inputs")
    if table.data_ptr() % 16:
        raise ValueError(f"{name} needs a 16-byte aligned table (the kernel loads int4)")


def _launch_bisect(table: torch.Tensor, k: int, thr_bits: int, plan: BisectPlan | None = None):
    """The op's CUDA implementation: one launch at ``bisect_plan``'s plan,
    or at ``plan`` where one is given."""
    _check_launch("bisect_count", table)
    bsz, m, _ = table.shape
    plan = plan or bisect_plan(bsz, m)
    t = torch.empty(bsz, dtype=torch.int32, device=table.device)
    cnt_gt = torch.empty(bsz, m, dtype=torch.int32, device=table.device)
    cnt_eq = torch.empty(bsz, m, dtype=torch.int32, device=table.device)
    _build.launch(
        bisect_count, "yt_bisect_count", table, table.data_ptr(), bsz, m, int(k), int(thr_bits),
        t.data_ptr(), cnt_gt.data_ptr(), cnt_eq.data_ptr(), plan.cluster, int(plan.resident),
    )
    return t, cnt_gt, cnt_eq


def _bisect_fake(table, k: int, thr_bits: int):
    bsz, m = table.shape[0], table.shape[1]
    cnt = table.new_empty(bsz, m, dtype=torch.int32)
    return table.new_empty(bsz, dtype=torch.int32), cnt, torch.empty_like(cnt)


def bisect_count(table: torch.Tensor, k: int, thr_bits: int):
    """Exact k-th largest valid score bits plus per-chunk tier counts.

    table (B, m, 128) f32 scores in [0, 2), k >= 1, thr_bits the f32 bits
    of a threshold >= 0.  Returns (t (B,) i32, cnt_gt (B, m) i32,
    cnt_eq (B, m) i32).  Calls the op ``yolort_tpu::bisect_count``: CUDA
    tensors launch the kernel on the current stream (``_launch_bisect``),
    at ``bisect_plan``'s cluster size and mode; CPU tensors take
    ``bisect_count_reference``."""
    if table.dim() != 3 or table.shape[-1] != 128 or table.dtype != torch.float32:
        raise ValueError(f"table must be (B, m, 128) float32, got {tuple(table.shape)} {table.dtype}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not 0 <= thr_bits < NO_VALID_BITS:
        raise ValueError(f"thr_bits must be the bits of a threshold in [0, 2), got {thr_bits:#x}")
    _on_cpu("bisect_count", table)
    return torch.ops.yolort_tpu.bisect_count(table, int(k), int(thr_bits))


register("bisect_count", bisect_count_reference, _launch_bisect, _bisect_fake, bisect_count)

_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
# row_fetch's launch geometry (csrc/row_fetch.cu): a warp a slice of
# consecutive slots, all of their rows in flight
FETCH_WARPS_PER_BLOCK = 4
FETCH_SMALL_SLOTS = 2048  # slots of all images below which a warp takes 2


def row_fetch_geometry(row_bytes: int, bsz: int, k: int) -> tuple:
    """``row_fetch``'s (warps per block, slots a warp copies, all their rows
    in flight) for rows of ``row_bytes`` bytes, ``bsz`` images and ``k``
    slots an image: 4 slots for rows of 16-byte words, 2 for rows of
    2- or 4-byte words, which take 4-8 times the loads and registers a row
    (the cells table's 510-byte rows), and 2 where the launch has fewer than
    ``FETCH_SMALL_SLOTS`` slots (batch 1 serving: 512), whose few warps
    then each wait on fewer rows.  As measured on the H100 by
    ``experiments/fetch_block_sweep.py`` (1-32 warps x 1-8 slots: 4 slots
    best at the stage-2 table, 2 at the cells table; the warps a block
    barely matter) and PERF.md, section 6."""
    rows = 4 if row_bytes % 16 == 0 and bsz * k >= FETCH_SMALL_SLOTS else 2
    return FETCH_WARPS_PER_BLOCK, rows


def row_fetch_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: table (B, m, w) f32|bf16, idx (B, k) int ->
    table[b, clamp(idx, 0, m-1)] as (B, k, w), copied as integer bits."""
    m, w = table.shape[1], table.shape[2]
    bits = table.contiguous().view(_INT_VIEW[table.dtype])
    rows = idx.long().clamp(0, m - 1)
    out = torch.gather(bits, 1, rows[..., None].expand(-1, -1, w))
    return out.view(table.dtype)


def _check_rows(name: str, table: torch.Tensor, idx: torch.Tensor) -> bool:
    """Check a row fetch's inputs; True when they lie on the CPU."""
    if table.dim() != 3 or table.dtype not in _INT_VIEW:
        raise ValueError(f"table must be (B, m, w) float32 or bfloat16, got {tuple(table.shape)} {table.dtype}")
    if idx.dim() != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(f"idx must be (B, k), got {tuple(idx.shape)} for table {tuple(table.shape)}")
    if idx.device != table.device:
        raise ValueError("table and idx must be on one device")
    if table.shape[1] < 1:
        raise ValueError(f"{name} needs a table with at least one row")
    if _on_cpu(name, table):
        return True
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32 on cuda, got {idx.dtype}")
    return False


def _launch_rows(table: torch.Tensor, idx: torch.Tensor,
                 geometry: tuple | None = None) -> torch.Tensor:
    """The op's CUDA implementation: one launch at ``row_fetch_geometry``'s
    geometry; at ``geometry`` (warps per block, slots a warp), a launch of
    ``row_fetch_p``."""
    wrapper = row_fetch if geometry is None else row_fetch_p
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError(f"{wrapper.__name__} needs contiguous table and idx")
    bsz, m, w = table.shape
    k = idx.shape[1]
    row_bytes = w * table.element_size()
    warps_per_block, rows_per_warp = geometry or row_fetch_geometry(row_bytes, bsz, k)
    out = torch.empty(bsz, k, w, dtype=table.dtype, device=table.device)
    _build.launch(
        wrapper, "yt_row_fetch_p", table, table.data_ptr(), idx.data_ptr(), out.data_ptr(), bsz,
        m, k, row_bytes, warps_per_block, rows_per_warp,
    )
    return out


def _row_fetch_fake(table, idx):
    return table.new_empty(table.shape[0], idx.shape[1], table.shape[2])


def row_fetch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bit-exact row gather, (B, m, w) f32|bf16 + (B, k) int32 -> (B, k, w),
    indices clamped to [0, m-1].  Calls the op ``yolort_tpu::row_fetch``:
    CUDA tensors launch the kernel on the current stream (``_launch_rows``),
    at ``row_fetch_geometry``'s launch; CPU tensors take
    ``row_fetch_reference``."""
    _check_rows("row_fetch", table, idx)
    return torch.ops.yolort_tpu.row_fetch(table, idx)


register("row_fetch", row_fetch_reference, _launch_rows, _row_fetch_fake, row_fetch)


def row_fetch_p(table: torch.Tensor, idx: torch.Tensor, warps_per_block: int,
                rows_per_warp: int) -> torch.Tensor:
    """``row_fetch`` at a chosen launch geometry: ``warps_per_block`` warps
    (1-32) in a block, each copying ``rows_per_warp`` (>= 1) consecutive
    output slots with all their rows in flight (in batches of at most 8,
    fewer where the block's registers would not hold them).  The result
    does not depend on the geometry: CPU tensors take
    ``row_fetch_reference``; CUDA tensors launch the kernel on the current
    stream.  A bad geometry raises."""
    if not (1 <= warps_per_block <= 32 and rows_per_warp >= 1):
        raise ValueError(f"row_fetch_p: warps_per_block must be in [1, 32] and rows_per_warp >= 1, "
                         f"got ({warps_per_block}, {rows_per_warp})")
    if _check_rows("row_fetch_p", table, idx):
        return row_fetch_reference(table, idx)
    return _launch_rows(table, idx, (int(warps_per_block), int(rows_per_warp)))


row_fetch_p.launches = 0


def _check_table(table: torch.Tensor, name: str) -> None:
    if table.dim() != 3 or table.shape[-1] != CHUNK or table.dtype != torch.float32:
        raise ValueError(f"{name}: table must be (B, m, 128) float32, got {tuple(table.shape)} {table.dtype}")
    if table.shape[1] < 1:
        raise ValueError(f"{name}: the table needs at least one row")


def extract_hits(rows: torch.Tensor, p: torch.Tensor, is_eq: torch.Tensor, t: torch.Tensor,
                 thr_bits: int):
    """Each slot's p-th lane, in lane order, of its fetched chunk row's tier
    mask (valid bits > thr_bits; gt tier bits >= t+1, eq tier bits == t):
    rows (B, k, 128) f32 -> (vals (B, k) f32, lane (B, k) i32), (0.0, 0)
    where the slot has no such lane.  Plain PyTorch."""
    rows_b = rows.view(torch.int32)
    tb = t[:, None, None]
    rows_m = (rows_b > thr_bits) & torch.where(is_eq[..., None], rows_b == tb, rows_b >= tb + 1)
    rank = rows_m.to(torch.int32).cumsum(-1) - 1  # exact in-lane rank
    hit = rows_m & (rank == p[..., None])
    vals = torch.where(hit, rows, 0.0).sum(-1)  # one term per slot: exact
    lane = torch.where(hit, torch.arange(CHUNK, device=rows.device), 0).sum(-1)
    return vals, lane.to(torch.int32)


def _check_lookup(name: str, table: torch.Tensor, off: torch.Tensor, k: int) -> bool:
    """Check a lookup-fetch's inputs; True when they lie on the CPU."""
    _check_table(table, name)
    bsz, m, _ = table.shape
    if off.shape != (bsz, 2 * m) or off.dtype != torch.int32:
        raise ValueError(f"{name}: off must be ({bsz}, {2 * m}) int32, got {tuple(off.shape)} {off.dtype}")
    if off.device != table.device:
        raise ValueError(f"{name}: table and off must be on one device")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    return _on_cpu(name, table)


def _launch_lookup(table: torch.Tensor, off: torch.Tensor, k: int, variant: str | None = None):
    """The op's CUDA implementation: one launch of the lookup-fetch kernel;
    for a ``variant``, a launch of ``lookup_fetch_variant``.  p and is_eq
    are allocated (else None) for the variants that write them."""
    wrapper = lookup_fetch if variant is None else lookup_fetch_variant
    _check_launch(wrapper.__name__, table, off)
    meta = variant not in ("fetch_only", "lookup_only")
    bsz, m, _ = table.shape
    rows = torch.empty(bsz, k, CHUNK, dtype=torch.float32, device=table.device)
    phys = torch.empty(bsz, k, dtype=torch.int32, device=table.device)
    p = torch.empty_like(phys) if meta else None
    is_eq = torch.empty(bsz, k, dtype=torch.bool, device=table.device) if meta else None
    _build.launch(
        wrapper, "yt_lookup_fetch_variant", table, table.data_ptr(), off.data_ptr(), bsz, m,
        int(k), rows.data_ptr(), phys.data_ptr(), p.data_ptr() if meta else None,
        is_eq.data_ptr() if meta else None, VARIANTS.index(variant or "full"),
    )
    return rows, phys, p, is_eq


def _lookup_fetch_fake(table, off, k: int):
    bsz = table.shape[0]
    phys = table.new_empty(bsz, k, dtype=torch.int32)
    return (table.new_empty(bsz, k, CHUNK), phys, torch.empty_like(phys),
            table.new_empty(bsz, k, dtype=torch.bool))


def lookup_fetch_reference(table: torch.Tensor, off: torch.Tensor, k: int):
    """Plain version: ``searchsorted`` over the offsets, then
    ``row_fetch_reference``.  See ``lookup_fetch``."""
    bsz, m, _ = table.shape
    s = torch.arange(k, dtype=off.dtype, device=off.device).expand(bsz, k).contiguous()
    c = (torch.searchsorted(off.contiguous(), s, right=True) - 1).clamp(0, 2 * m - 1)
    is_eq = c >= m
    phys = (c - m * is_eq.long()).to(torch.int32)
    p = (s - torch.gather(off, 1, c)).to(torch.int32)
    return row_fetch_reference(table, phys), phys, p, is_eq


def lookup_fetch(table: torch.Tensor, off: torch.Tensor, k: int):
    """Slot -> chunk lookup plus the chunk-row fetch.

    table (B, m, 128) f32; off (B, 2m) i32, the exclusive offsets of the
    gt-tier chunks then the eq-tier chunks (nondecreasing); k >= 1.  For
    slot s: c = (number of offsets <= s) - 1 clipped to [0, 2m-1],
    is_eq = c >= m, phys = c - m*is_eq, p = s - off[c].  Returns (rows
    (B, k, 128) f32 with the bits of table[b, phys], phys (B, k) i32,
    p (B, k) i32, is_eq (B, k) bool).  Calls the op
    ``yolort_tpu::lookup_fetch``: CUDA tensors launch the kernel on the
    current stream (``_launch_lookup``); CPU tensors take
    ``lookup_fetch_reference``."""
    _check_lookup("lookup_fetch", table, off, k)
    return torch.ops.yolort_tpu.lookup_fetch(table, off, int(k))


register("lookup_fetch", lookup_fetch_reference, _launch_lookup, _lookup_fetch_fake, lookup_fetch)

# the stripped variants of the lookup-fetch, in the C entry point's order
VARIANTS = ("full", "no_boundary", "no_fetch", "fetch_only", "lookup_only")
_PAD_OFFSET = 2**30  # pads the offsets to whole 128-offset rows; above every slot


def lookup_fetch_variant_reference(table: torch.Tensor, off: torch.Tensor, k: int, variant: str):
    """Plain version of ``lookup_fetch_variant``."""
    bsz, m, _ = table.shape
    if variant == "fetch_only":
        s = torch.arange(k, device=off.device)
        phys = (s // 2).clamp(max=m - 1).to(torch.int32).expand(bsz, k).contiguous()
        return row_fetch_reference(table, phys), phys, None, None
    if variant == "no_boundary":
        s = torch.arange(k, dtype=torch.int64, device=off.device)
        pad = off.new_full((bsz, (-2 * m) % CHUNK), _PAD_OFFSET)
        rowmax = torch.cat([off, pad], 1).view(bsz, -1, CHUNK).amax(-1).long()  # (B, rows)
        full = rowmax[:, None, :] <= s[None, :, None]  # (B, k, rows)
        c = (CHUNK * full.sum(-1) - 1).clamp(0, 2 * m - 1)
        is_eq = c >= m
        phys = (c - m * is_eq.long()).to(torch.int32)
        p = (s - torch.where(full, rowmax[:, None, :], 0).amax(-1)).to(torch.int32)
        rows = row_fetch_reference(table, phys)
    else:
        rows, phys, p, is_eq = lookup_fetch_reference(table, off, k)
    if variant in ("no_fetch", "lookup_only"):
        rows = phys[..., None].expand(-1, -1, CHUNK).contiguous().view(torch.float32)
    if variant == "lookup_only":
        p = is_eq = None
    return rows, phys, p, is_eq


def lookup_fetch_variant(table: torch.Tensor, off: torch.Tensor, k: int, variant: str):
    """A stripped variant of ``lookup_fetch``, for timing where its time
    goes (one of ``VARIANTS``):

      * ``'full'``: ``lookup_fetch`` itself;
      * ``'no_boundary'``: the coarse search alone: c = clip(128 R - 1, 0,
        2m - 1), R the number of whole 128-offset rows (the offsets padded
        with 2^30 to a multiple of 128) whose largest offset is <= s;
        p = s - (the largest offset in those rows, 0 if none); is_eq and
        phys from c as in ``lookup_fetch``; rows fetched;
      * ``'no_fetch'``: as ``'full'``, but every lane of a slot's row holds
        phys (int32 bits) in place of the table row;
      * ``'fetch_only'``: no lookup: phys = min(s // 2, m - 1), rows
        fetched; p and is_eq are None;
      * ``'lookup_only'``: phys as ``'full'``, rows as ``'no_fetch'``; p and
        is_eq are None.

    Inputs as ``lookup_fetch``.  Returns (rows, phys, p, is_eq).  CUDA
    tensors launch the kernel on the current stream; CPU tensors take
    ``lookup_fetch_variant_reference``.  An unknown variant raises."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if _check_lookup("lookup_fetch_variant", table, off, k):
        return lookup_fetch_variant_reference(table, off, k, variant)
    return _launch_lookup(table, off, k, variant)


lookup_fetch_variant.launches = 0


def select_extract_reference(table, phys, p, is_eq, t, thr_bits: int):
    """Plain version: ``row_fetch_reference`` then ``extract_hits``."""
    return extract_hits(row_fetch_reference(table, phys), p, is_eq, t, thr_bits)


def _select_extract_cuda(table, phys, p, is_eq, t, thr_bits: int):
    """The op's CUDA implementation: one launch on checked inputs."""
    _check_launch("select_extract", table, phys, p, is_eq, t)
    bsz, m, _ = table.shape
    k = phys.shape[1]
    vals = torch.empty(bsz, k, dtype=torch.float32, device=table.device)
    lane = torch.empty(bsz, k, dtype=torch.int32, device=table.device)
    _build.launch(
        select_extract, "yt_select_extract", table, table.data_ptr(), phys.data_ptr(),
        p.data_ptr(), is_eq.data_ptr(), t.data_ptr(), int(thr_bits), bsz, m, k, vals.data_ptr(),
        lane.data_ptr(),
    )
    return vals, lane


def _select_extract_fake(table, phys, p, is_eq, t, thr_bits: int):
    return (table.new_empty(phys.shape, dtype=torch.float32),
            table.new_empty(phys.shape, dtype=torch.int32))


def select_extract(table: torch.Tensor, phys: torch.Tensor, p: torch.Tensor,
                   is_eq: torch.Tensor, t: torch.Tensor, thr_bits: int):
    """In-kernel extraction: per slot, the chunk row table[b, clamp(phys)],
    its tier mask against t (``extract_hits``), and the p-th set lane.

    table (B, m, 128) f32; phys, p (B, k) i32; is_eq (B, k) bool; t (B,)
    i32 k-th value bits; thr_bits the f32 bits of a threshold >= 0.
    Returns (vals (B, k) f32, lane (B, k) i32), (0.0, 0) for a slot with
    no hit.  Calls the op ``yolort_tpu::select_extract``: CUDA tensors
    launch the kernel on the current stream (``_select_extract_cuda``); CPU
    tensors take ``select_extract_reference``."""
    _check_table(table, "select_extract")
    bsz, m, _ = table.shape
    if not (phys.dim() == 2 and phys.shape[0] == bsz and p.shape == is_eq.shape == phys.shape):
        raise ValueError(f"select_extract: phys, p and is_eq must be (B, k) for table {tuple(table.shape)}, "
                         f"got {tuple(phys.shape)}, {tuple(p.shape)}, {tuple(is_eq.shape)}")
    if any(x.device != table.device for x in (phys, p, is_eq)):
        raise ValueError("select_extract: every input must be on the table's device")
    if t.shape != (bsz,) or t.device != table.device:
        raise ValueError(f"select_extract: t must be ({bsz},) on the table's device, got {tuple(t.shape)}")
    if not 0 <= thr_bits < NO_VALID_BITS:
        raise ValueError(f"thr_bits must be the bits of a threshold in [0, 2), got {thr_bits:#x}")
    if not _on_cpu("select_extract", table) and (phys.dtype, p.dtype, is_eq.dtype, t.dtype) != (
            torch.int32, torch.int32, torch.bool, torch.int32):
        raise ValueError("select_extract: phys, p and t must be int32 and is_eq bool on cuda")
    return torch.ops.yolort_tpu.select_extract(table, phys, p, is_eq, t, int(thr_bits))


register("select_extract", select_extract_reference, _select_extract_cuda, _select_extract_fake,
         select_extract)
