"""Greedy NMS keep mask: the CUDA kernel ``csrc/nms_mask.cu`` and its plain
PyTorch version.

Replaces ``yolort_tpu/ops/pallas/nms_kernel.py`` (``_nms_kernel`` /
``pallas_nms_mask``).  The kernel is one launch, one block per image: it
walks the candidates a tile of 256 at a time, tests each against the boxes
kept so far (a list in a scratch buffer, read back through shared memory),
builds the tile's own IoU relation in shared memory and walks it from keep
to keep; the source note says what bounds it on the H100.
Both versions compute what ``yolort_tpu.ops.nms.greedy_nms_mask`` computes,
for the whole mask and any K: exact sequential greedy NMS through the tile
at which ``stop_after`` keeps are final, validity passed through after it.
"""

from __future__ import annotations

import torch

from yolort_tpu_torch.ops.boxes import box_iou_matrix
from yolort_tpu_torch.ops.cuda import _build
from yolort_tpu_torch.ops.library import register


def nms_mask_reference(
    boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
    tile_size: int = 256, stop_after: int = 0,
) -> torch.Tensor:
    """Plain batched greedy NMS: boxes (B, K, 4) xyxy f32, score-sorted and
    class-offset; valid (B, K) bool -> keep (B, K) bool.

    Tiles of ``tile_size`` take suppression from the finalized earlier
    tiles, then iterate ``alive <- valid & ~any(sup & alive)`` to its fixed
    point, which is the sequential greedy result because ``sup`` is strictly
    upper-triangular in score order.  With ``stop_after > 0`` an image stops
    at the first tile boundary with that many keeps; its later tiles keep
    their validity."""
    bsz, k, _ = boxes.shape
    t = min(tile_size, k)
    pad = (-k) % t
    if pad:
        boxes = torch.cat([boxes, boxes.new_zeros(bsz, pad, 4)], dim=1)
        valid = torch.cat([valid, valid.new_zeros(bsz, pad)], dim=1)
    kp = k + pad
    thr = torch.tensor(iou_thresh, dtype=torch.float32, device=boxes.device)
    stop = stop_after if stop_after > 0 else kp
    tri = torch.ones(t, t, dtype=torch.bool, device=boxes.device).triu(1)
    alive = valid.clone()
    kept = torch.zeros(bsz, dtype=torch.int64, device=boxes.device)
    for start in range(0, kp, t):
        active = kept < stop
        if not bool(active.any()):
            break
        iou = box_iou_matrix(boxes[:, start:start + t], boxes[:, :start + t]) > thr
        sup_prev = (iou[:, :, :start] & alive[:, None, :start]).any(-1)
        tile_valid = valid[:, start:start + t] & ~sup_prev
        sup_tt = iou[:, :, start:start + t] & tri
        a = tile_valid
        while True:
            new = tile_valid & ~(sup_tt & a[:, :, None]).any(1)
            if torch.equal(new, a):
                break
            a = new
        tile_alive = torch.where(active[:, None], a, alive[:, start:start + t])
        alive[:, start:start + t] = tile_alive
        kept += tile_alive.sum(-1)
    return alive[:, :k].contiguous()  # the kernel's layout


def _nms_cuda(boxes, valid, iou_thresh: float, tile_size: int, stop_after: int):
    """The op's CUDA implementation: one launch on checked inputs."""
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_mask needs contiguous boxes and valid")
    if boxes.data_ptr() % 16:
        raise ValueError("nms_mask needs 16-byte aligned boxes (the kernel loads float4)")
    bsz, k, _ = boxes.shape
    tile = min(tile_size, k)
    stop = min(stop_after, k + 1) if stop_after > 0 else k + 1  # k + 1: no early exit
    keep = torch.empty_like(valid)
    # the kept-box list: as many rows an image as the kernel says it can keep
    rows = _build.library().yt_nms_scratch_rows(k, tile, stop)
    scratch = torch.empty(bsz, rows, 4, dtype=torch.float32, device=boxes.device)
    _build.launch(
        nms_mask, "yt_nms_mask", boxes, boxes.data_ptr(), valid.data_ptr(), keep.data_ptr(),
        scratch.data_ptr(), bsz, k, float(iou_thresh), tile, stop,
    )
    return keep


def _nms_fake(boxes, valid, iou_thresh: float, tile_size: int, stop_after: int):
    return torch.empty_like(valid)


def nms_mask(
    boxes: torch.Tensor, valid: torch.Tensor, iou_thresh: float,
    tile_size: int = 256, stop_after: int = 0,
) -> torch.Tensor:
    """Greedy NMS keep mask, (B, K, 4) f32 + (B, K) bool -> (B, K) bool.

    Calls the op ``yolort_tpu::nms_mask``: CUDA tensors launch
    ``csrc/nms_mask.cu`` on the current stream (``_nms_cuda``, no
    synchronisation); CPU tensors take ``nms_mask_reference``.  Any other
    device, or input the kernel does not take, raises."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or boxes.dtype != torch.float32:
        raise ValueError(f"boxes must be (B, K, 4) float32, got {tuple(boxes.shape)} {boxes.dtype}")
    if valid.shape != boxes.shape[:2] or valid.dtype != torch.bool:
        raise ValueError(f"valid must be (B, K) bool, got {tuple(valid.shape)} {valid.dtype}")
    if valid.device != boxes.device:
        raise ValueError("boxes and valid must be on one device")
    if tile_size <= 0:
        raise ValueError(f"tile_size must be positive, got {tile_size}")
    if boxes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nms_mask runs on cuda or cpu tensors, not {boxes.device}")
    return torch.ops.yolort_tpu.nms_mask(boxes, valid, float(iou_thresh), int(tile_size),
                                         int(stop_after))


register("nms_mask", nms_mask_reference, _nms_cuda, _nms_fake, nms_mask)
