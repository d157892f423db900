"""Stage-2 selection kernels: ``bisect_count`` (``csrc/bisect_count.cu``) and
``row_fetch`` (``csrc/row_fetch.cu``), each with its plain PyTorch version.

Replace ``yolort_tpu/ops/pallas/lookup_kernel.py``: ``_bisect_count_kernel``
/ ``pallas_bisect_count`` and ``_fetch_kernel`` + ``_fetch_block_bits`` /
``pallas_row_fetch``.  The TPU kernels keep the chunk table in VMEM and
fetch rows with byte-plane one-hot matmuls to dodge the TPU's slow
gathers; on the H100 the first is a radix select over the bit patterns and
the second a plain warp-per-row gather (the source notes say what bounds
each).  Both are batched over a leading image dimension.
"""

from __future__ import annotations

import torch

from yolort_tpu_torch.ops.cuda import _build

# bits of 2.0f: the k-th value when no entry is valid (and the bisection's
# upper bound; valid scores sit below it)
NO_VALID_BITS = 0x40000000


def bisect_count_reference(table: torch.Tensor, k: int, thr_bits: int):
    """Plain version: table (B, m, 128) f32 -> t (B,) i32, the k-th largest
    valid bit pattern (valid = bits > thr_bits) as ``_bisect_kth_bits``
    defines it, and the per-chunk counts cnt_gt (B, m) of valid bits >= t+1
    and cnt_eq (B, m) of valid bits == t, both i32."""
    from yolort_tpu_torch.ops.select import _bisect_kth_bits

    bsz = table.shape[0]
    bits = table.contiguous().view(torch.int32)
    valid = bits > thr_bits
    t = _bisect_kth_bits(bits.reshape(bsz, -1), valid.reshape(bsz, -1), k)
    tb = t[:, None, None]
    gt = valid & (bits >= tb + 1)  # int32 wrap-around, as in JAX
    eq = valid & (bits == tb)
    return t, gt.sum(-1, dtype=torch.int32), eq.sum(-1, dtype=torch.int32)


def bisect_count(table: torch.Tensor, k: int, thr_bits: int):
    """Exact k-th largest valid score bits plus per-chunk tier counts.

    table (B, m, 128) f32 scores in [0, 2), k >= 1, thr_bits the f32 bits
    of a threshold >= 0.  Returns (t (B,) i32, cnt_gt (B, m) i32,
    cnt_eq (B, m) i32).  CUDA tensors launch the kernel on the current
    stream; CPU tensors take ``bisect_count_reference``."""
    if table.dim() != 3 or table.shape[-1] != 128 or table.dtype != torch.float32:
        raise ValueError(f"table must be (B, m, 128) float32, got {tuple(table.shape)} {table.dtype}")
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    if not 0 <= thr_bits < NO_VALID_BITS:
        raise ValueError(f"thr_bits must be the bits of a threshold in [0, 2), got {thr_bits:#x}")
    if table.device.type == "cpu":
        return bisect_count_reference(table, k, thr_bits)
    if table.device.type != "cuda":
        raise ValueError(f"bisect_count runs on cuda or cpu tensors, not {table.device}")
    if not table.is_contiguous():
        raise ValueError("bisect_count needs a contiguous table")
    if table.data_ptr() % 16:
        raise ValueError("bisect_count needs a 16-byte aligned table (the kernel loads int4)")
    bsz, m, _ = table.shape
    t = torch.empty(bsz, dtype=torch.int32, device=table.device)
    cnt_gt = torch.empty(bsz, m, dtype=torch.int32, device=table.device)
    cnt_eq = torch.empty(bsz, m, dtype=torch.int32, device=table.device)
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.yt_bisect_count(
            table.data_ptr(), bsz, m, int(k), int(thr_bits),
            t.data_ptr(), cnt_gt.data_ptr(), cnt_eq.data_ptr(), _build.stream_of(table),
        )
    _build.check(rc, "bisect_count")
    bisect_count.launches += 1
    return t, cnt_gt, cnt_eq


bisect_count.launches = 0

_INT_VIEW = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def row_fetch_reference(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: table (B, m, w) f32|bf16, idx (B, k) int ->
    table[b, clamp(idx, 0, m-1)] as (B, k, w), copied as integer bits."""
    m, w = table.shape[1], table.shape[2]
    bits = table.contiguous().view(_INT_VIEW[table.dtype])
    rows = idx.long().clamp(0, m - 1)
    out = torch.gather(bits, 1, rows[..., None].expand(-1, -1, w))
    return out.view(table.dtype)


def row_fetch(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Bit-exact row gather, (B, m, w) f32|bf16 + (B, k) int32 -> (B, k, w),
    indices clamped to [0, m-1].  CUDA tensors launch the kernel on the
    current stream; CPU tensors take ``row_fetch_reference``."""
    if table.dim() != 3 or table.dtype not in _INT_VIEW:
        raise ValueError(f"table must be (B, m, w) float32 or bfloat16, got {tuple(table.shape)} {table.dtype}")
    if idx.dim() != 2 or idx.shape[0] != table.shape[0]:
        raise ValueError(f"idx must be (B, k), got {tuple(idx.shape)} for table {tuple(table.shape)}")
    if idx.device != table.device:
        raise ValueError("table and idx must be on one device")
    if table.shape[1] < 1:
        raise ValueError("row_fetch needs a table with at least one row")
    if table.device.type == "cpu":
        return row_fetch_reference(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"row_fetch runs on cuda or cpu tensors, not {table.device}")
    if idx.dtype != torch.int32:
        raise ValueError(f"idx must be int32 on cuda, got {idx.dtype}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_fetch needs contiguous table and idx")
    bsz, m, w = table.shape
    k = idx.shape[1]
    out = torch.empty(bsz, k, w, dtype=table.dtype, device=table.device)
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.yt_row_fetch(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), bsz, m, k,
            w * table.element_size(), _build.stream_of(table),
        )
    _build.check(rc, "row_fetch")
    row_fetch.launches += 1
    return out


row_fetch.launches = 0
