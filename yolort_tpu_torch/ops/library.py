"""The serving routes' kernels as PyTorch dispatcher ops, namespace
``yolort_tpu``.

One op for each kernel entry point the postprocess launches, each with a
fixed schema and three implementations:

  * ``CPU``: the kernel's plain PyTorch version (``*_reference``);
  * ``CUDA``: the kernel's launch on the current stream, with its host-side
    plan, its alignment checks and its launch count (the ``launches``
    attribute of the Python wrapper, ``ops/cuda/*_kernel.py``);
  * fake (``register_fake``): output shapes and dtypes only, for
    ``torch.export``, AOTInductor and ``torch.compile``.

Dispatch is by the inputs' device alone: a CUDA tensor reaches the kernel
or raises, a CPU tensor the plain version.  The Python wrappers check
shapes, dtypes, devices and contiguity and then call
``torch.ops.yolort_tpu.<op>``, so an eager call, a CUDA-graph capture, an
exported program and an AOTInductor package launch the same kernel.
Python ``float`` / ``int`` arguments are schema scalars: an exported
program records them as constants.

``csrc/torch_ops.cpp`` defines the same schemas (``SCHEMAS``) with the same
CUDA launches for a process without Python (``deployment/libtorch``); it
is never loaded where this module is.  The int8 conv kernels are not ops
yet: ``QCONV_OPS`` names them for the error an int8 export raises.
"""

from __future__ import annotations

import math

import torch

from yolort_tpu_torch.ops.cuda import _build, lookup_kernel, nms_kernel, stage1_kernel

NAMESPACE = "yolort_tpu"
SCHEMAS = {
    "fused_cells_stage1":
        "fused_cells_stage1(Tensor[] levels, int num_anchors, int kw) -> (Tensor, Tensor, Tensor)",
    "bisect_count": "bisect_count(Tensor table, int k, int thr_bits) -> (Tensor, Tensor, Tensor)",
    "row_fetch": "row_fetch(Tensor table, Tensor idx) -> Tensor",
    "lookup_fetch":
        "lookup_fetch(Tensor table, Tensor off, int k) -> (Tensor, Tensor, Tensor, Tensor)",
    "select_extract": "select_extract(Tensor table, Tensor phys, Tensor p, Tensor is_eq, "
                      "Tensor t, int thr_bits) -> (Tensor, Tensor)",
    "nms_mask": "nms_mask(Tensor boxes, Tensor valid, float iou_thresh, int tile_size, "
                "int stop_after) -> Tensor",
}
# the int8 conv kernels, launched by quantized models, not yet ops
QCONV_OPS = ("qconv1x1", "qconv_kxk", "qconv_grouped")

_LIB = torch.library.Library(NAMESPACE, "DEF")
for _schema in SCHEMAS.values():
    _LIB.define(_schema)


# ---------------------------------------------------------------- CUDA ----

def _stage1_cuda(levels, num_anchors: int, kw: int):
    first = levels[0]
    if not all(lv.is_contiguous() for lv in levels):
        raise ValueError("fused_cells_stage1 needs contiguous levels (NHWC head outputs as views)")
    bsz, C = first.shape[0], num_anchors * kw
    rows = [stage1_kernel._rows(lv) for lv in levels]
    n_cells = sum(rows)
    cells = torch.empty(bsz, n_cells, C, dtype=first.dtype, device=first.device)
    obj = torch.empty(bsz, n_cells, num_anchors, dtype=first.dtype, device=first.device)
    cls = torch.empty_like(obj)
    pad = stage1_kernel.MAX_LEVELS - len(levels)
    neg = float(torch.tensor(stage1_kernel.NEG_LOGIT, dtype=first.dtype))  # -9984.0 in bfloat16
    lib = _build.library()
    with torch.cuda.device(first.device):
        rc = lib.yt_cells_stage1(
            *[lv.data_ptr() for lv in levels], *[None] * pad, *rows, *[0] * pad, len(levels),
            bsz, C, num_anchors, kw, neg, first.element_size(), cells.data_ptr(),
            obj.data_ptr(), cls.data_ptr(), _build.stream_of(first),
        )
    _build.check(rc, "fused_cells_stage1")
    stage1_kernel.fused_cells_stage1.launches += 1
    return cells, obj, cls


def _bisect_cuda(table, k: int, thr_bits: int):
    lookup_kernel._check_cuda("bisect_count", table)
    lookup_kernel._check_aligned("bisect_count", table)
    out = lookup_kernel._launch_bisect(table, k, thr_bits,
                                       lookup_kernel.bisect_plan(table.shape[0], table.shape[1]))
    lookup_kernel.bisect_count.launches += 1
    return out


def _row_fetch_cuda(table, idx):
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("row_fetch needs contiguous table and idx")
    geometry = lookup_kernel.row_fetch_geometry(table.shape[2] * table.element_size(), *idx.shape)
    out = lookup_kernel._launch_rows(table, idx, *geometry)
    lookup_kernel.row_fetch.launches += 1
    return out


def _lookup_fetch_cuda(table, off, k: int):
    lookup_kernel._check_cuda("lookup_fetch", table, off)
    lookup_kernel._check_aligned("lookup_fetch", table)
    out = lookup_kernel._launch_lookup(table, off, k, "full")
    lookup_kernel.lookup_fetch.launches += 1
    return out


def _select_extract_cuda(table, phys, p, is_eq, t, thr_bits: int):
    lookup_kernel._check_cuda("select_extract", table, phys, p, is_eq, t)
    lookup_kernel._check_aligned("select_extract", table)
    bsz, m, _ = table.shape
    k = phys.shape[1]
    vals = torch.empty(bsz, k, dtype=torch.float32, device=table.device)
    lane = torch.empty(bsz, k, dtype=torch.int32, device=table.device)
    lib = _build.library()
    with torch.cuda.device(table.device):
        rc = lib.yt_select_extract(
            table.data_ptr(), phys.data_ptr(), p.data_ptr(), is_eq.data_ptr(), t.data_ptr(),
            int(thr_bits), bsz, m, k, vals.data_ptr(), lane.data_ptr(), _build.stream_of(table),
        )
    _build.check(rc, "select_extract")
    lookup_kernel.select_extract.launches += 1
    return vals, lane


def _nms_cuda(boxes, valid, iou_thresh: float, tile_size: int, stop_after: int):
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_mask needs contiguous boxes and valid")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_mask needs 16-byte aligned boxes (the kernel loads float4)")
    bsz, k, _ = boxes.shape
    tile = min(tile_size, k)
    stop = min(stop_after, k + 1) if stop_after > 0 else k + 1  # k + 1: no early exit
    keep = torch.empty_like(valid)
    lib = _build.library()
    # the kept-box list: as many rows an image as the kernel says it can keep
    rows = lib.yt_nms_scratch_rows(k, tile, stop)
    scratch = torch.empty(bsz, rows, 4, dtype=torch.float32, device=boxes.device)
    with torch.cuda.device(boxes.device):
        rc = lib.yt_nms_mask(
            boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(), scratch.data_ptr(), bsz, k,
            float(iou_thresh), tile, stop, _build.stream_of(boxes),
        )
    _build.check(rc, "nms_mask")
    nms_kernel.nms_mask.launches += 1
    return keep


# ---------------------------------------------------------------- fake ----

def _stage1_fake(levels, num_anchors: int, kw: int):
    first = levels[0]
    n_cells = sum(math.prod(lv.shape[1:-1]) for lv in levels)
    cells = first.new_empty(first.shape[0], n_cells, num_anchors * kw)
    obj = first.new_empty(first.shape[0], n_cells, num_anchors)
    return cells, obj, torch.empty_like(obj)


def _bisect_fake(table, k: int, thr_bits: int):
    bsz, m = table.shape[0], table.shape[1]
    cnt = table.new_empty(bsz, m, dtype=torch.int32)
    return table.new_empty(bsz, dtype=torch.int32), cnt, torch.empty_like(cnt)


def _row_fetch_fake(table, idx):
    return table.new_empty(table.shape[0], idx.shape[1], table.shape[2])


def _lookup_fetch_fake(table, off, k: int):
    bsz = table.shape[0]
    phys = table.new_empty(bsz, k, dtype=torch.int32)
    return (table.new_empty(bsz, k, lookup_kernel.CHUNK), phys, torch.empty_like(phys),
            table.new_empty(bsz, k, dtype=torch.bool))


def _select_extract_fake(table, phys, p, is_eq, t, thr_bits: int):
    return (table.new_empty(phys.shape, dtype=torch.float32),
            table.new_empty(phys.shape, dtype=torch.int32))


def _nms_fake(boxes, valid, iou_thresh: float, tile_size: int, stop_after: int):
    return torch.empty_like(valid)


_IMPLS = {
    "fused_cells_stage1": (stage1_kernel.fused_cells_stage1_reference, _stage1_cuda,
                           _stage1_fake),
    "bisect_count": (lookup_kernel.bisect_count_reference, _bisect_cuda, _bisect_fake),
    "row_fetch": (lookup_kernel.row_fetch_reference, _row_fetch_cuda, _row_fetch_fake),
    "lookup_fetch": (lookup_kernel.lookup_fetch_reference, _lookup_fetch_cuda,
                     _lookup_fetch_fake),
    "select_extract": (lookup_kernel.select_extract_reference, _select_extract_cuda,
                       _select_extract_fake),
    "nms_mask": (nms_kernel.nms_mask_reference, _nms_cuda, _nms_fake),
}
for _name, (_cpu, _cuda, _fake) in _IMPLS.items():
    _LIB.impl(_name, _cpu, "CPU")
    _LIB.impl(_name, _cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{_name}", _fake, lib=_LIB)


def op(name: str):
    """The dispatcher op ``yolort_tpu::<name>`` (its default overload)."""
    return getattr(getattr(torch.ops, NAMESPACE), name).default
