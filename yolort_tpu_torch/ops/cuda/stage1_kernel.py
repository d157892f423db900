"""Stage-1 screen kernel: ``fused_cells_stage1`` (``csrc/cells_stage1.cu``)
with its plain PyTorch version.

Replaces ``yolort_tpu/ops/pallas/s1_kernel.py`` (``_kernel`` /
``fused_cells_stage1``): one pass that writes the head levels into the
concatenated cells table and takes each anchor's max obj logit and max
class logit on the way.  The sigmoid product stays with the caller
(``ops.nms._stage1_scores``), as it does in the JAX package.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Sequence

import torch

from yolort_tpu_torch.ops.cuda import _build
from yolort_tpu_torch.ops.library import register

NEG_LOGIT = -1.0e4  # floor of the masked maxima, as the JAX reductions fill
MAX_LEVELS = 4


class Stage1Plan(NamedTuple):
    """The kernel's tiling on a card, as ``csrc/cells_stage1.cu``
    (``make_plan``) chooses it: rows of one level a tile, stages of the
    shared-memory ring, bytes of a stage, dynamic shared memory of a block,
    and the persistent grid's size (blocks an SM x SMs)."""

    rows: int
    stages: int
    stage_bytes: int
    smem: int
    grid: int


def stage1_plan(row_len: int, dtype: torch.dtype) -> Stage1Plan:
    """The plan ``fused_cells_stage1`` launches with on the current CUDA
    device for rows of ``row_len`` = A*kw values of ``dtype``.  Builds the
    kernels on first use."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    out = (ctypes.c_int * 5)()
    rc = _build.library().yt_cells_stage1_plan(row_len, torch.finfo(dtype).bits // 8,
                                               ctypes.addressof(out))
    _build.check(rc, "fused_cells_stage1 plan")
    return Stage1Plan(*out)


def _rows(level: torch.Tensor) -> int:
    return math.prod(level.shape[1:-1])


def fused_cells_stage1_reference(levels: Sequence[torch.Tensor], num_anchors: int, kw: int):
    """Plain version: ``torch.cat`` of the levels as (B, R_l, C), then each
    anchor's obj logit and largest class logit, floored at -1e4 in the
    levels' dtype.  NaN propagates (torch.maximum / amax)."""
    bsz = levels[0].shape[0]
    cells = torch.cat([lv.reshape(bsz, _rows(lv), lv.shape[-1]) for lv in levels], dim=1)
    x = cells.unflatten(-1, (num_anchors, kw))
    neg = torch.tensor(NEG_LOGIT, dtype=cells.dtype, device=cells.device)
    return cells, torch.maximum(x[..., 4], neg), torch.maximum(x[..., 5:].amax(-1), neg)


def _stage1_cuda(levels, num_anchors: int, kw: int):
    """The op's CUDA implementation: one launch on checked levels."""
    if not all(lv.is_contiguous() for lv in levels):
        raise ValueError("fused_cells_stage1 needs contiguous levels (NHWC head outputs as views)")
    first = levels[0]
    bsz, C = first.shape[0], num_anchors * kw
    rows = [_rows(lv) for lv in levels]
    n_cells = sum(rows)
    cells = torch.empty(bsz, n_cells, C, dtype=first.dtype, device=first.device)
    obj = torch.empty(bsz, n_cells, num_anchors, dtype=first.dtype, device=first.device)
    cls = torch.empty_like(obj)
    pad = MAX_LEVELS - len(levels)
    neg = float(torch.tensor(NEG_LOGIT, dtype=first.dtype))  # -9984.0 in bfloat16
    _build.launch(
        fused_cells_stage1, "yt_cells_stage1", first, *[lv.data_ptr() for lv in levels],
        *[None] * pad, *rows, *[0] * pad, len(levels), bsz, C, num_anchors, kw, neg,
        first.element_size(), cells.data_ptr(), obj.data_ptr(), cls.data_ptr(),
    )
    return cells, obj, cls


def _stage1_fake(levels, num_anchors: int, kw: int):
    first = levels[0]
    n_cells = sum(_rows(lv) for lv in levels)
    cells = first.new_empty(first.shape[0], n_cells, num_anchors * kw)
    obj = first.new_empty(first.shape[0], n_cells, num_anchors)
    return cells, obj, torch.empty_like(obj)


def fused_cells_stage1(levels: Sequence[torch.Tensor], num_anchors: int, kw: int):
    """Cells table and stage-1 maxima in one pass.

    levels: 1-4 head outputs (B, H, W, C) or (B, R, C), C = A*kw, one dtype
    (float32 or bfloat16).  Returns (cells (B, sum R_l, C), obj (B, sum R_l,
    A), cls (B, sum R_l, A)) in that dtype, equal to
    ``fused_cells_stage1_reference``.  Calls the op
    ``yolort_tpu::fused_cells_stage1``: CUDA tensors launch the kernel on
    the current stream (``_stage1_cuda``) and must be contiguous (a
    strided level raises rather than being copied); any base address and
    row count is taken.  CPU tensors take the plain version."""
    levels = list(levels)
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"fused_cells_stage1 takes 1-{MAX_LEVELS} levels, got {len(levels)}")
    first = levels[0]
    C = num_anchors * kw
    if num_anchors < 1 or kw < 6:
        raise ValueError(f"need num_anchors >= 1 and kw >= 6 (one class at least), got {num_anchors}, {kw}")
    if first.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"levels must be float32 or bfloat16, got {first.dtype}")
    for lv in levels:
        if lv.dim() < 3 or lv.shape[0] != first.shape[0] or lv.shape[-1] != C:
            raise ValueError(f"levels must be (B, ..., {C}) with one batch size, got {tuple(lv.shape)}")
        if lv.dtype != first.dtype or lv.device != first.device:
            raise ValueError("levels must share one dtype and one device")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_cells_stage1 runs on cuda or cpu tensors, not {first.device}")
    return torch.ops.yolort_tpu.fused_cells_stage1(levels, num_anchors, kw)


register("fused_cells_stage1", fused_cells_stage1_reference, _stage1_cuda, _stage1_fake,
         fused_cells_stage1)
