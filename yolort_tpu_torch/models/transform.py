"""Letterbox pre-processing and the inverse box transform.

Port of ``yolort_tpu/models/transform.py``.  The plan is pure Python over
image sizes, with the reference numerics: scale = min(min_size/min(h, w),
max_size/max(h, w)); resized sides floored; canvas rounded up to
``size_divisible`` (or ``fixed_shape``); offsets int(round(d/2 - 0.1));
fill 114/255.  Images are NHWC at this module's surface.

Three letterboxes share one resize, half-pixel bilinear without
antialias: ``letterbox_batch`` (a same-size batch, on the model's device),
``letterbox_images`` (images of any sizes, each into its slice of one
fixed canvas, on the device) and ``letterbox_numpy`` (one image on the
host, in numpy: no OpenCV).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class LetterboxPlan:
    """Letterbox plan for one raw image size."""

    orig_hw: Tuple[int, int]
    resized_hw: Tuple[int, int]
    canvas_hw: Tuple[int, int]
    offset_hw: Tuple[int, int]


def resize_shape(h: int, w: int, min_size: int, max_size: int) -> Tuple[int, int]:
    scale = min(float(min_size) / min(h, w), float(max_size) / max(h, w))
    return int(math.floor(h * scale)), int(math.floor(w * scale))


def make_plan(
    sizes: Sequence[Tuple[int, int]],
    min_size: int = 640,
    max_size: int = 640,
    size_divisible: int = 32,
    fixed_shape: Optional[Tuple[int, int]] = None,
) -> List[LetterboxPlan]:
    """The batch letterbox plan for a list of raw (h, w) sizes."""
    resized = [resize_shape(h, w, min_size, max_size) for h, w in sizes]
    if fixed_shape is not None:
        canvas = (int(fixed_shape[0]), int(fixed_shape[1]))
    else:
        mh = max(r[0] for r in resized)
        mw = max(r[1] for r in resized)
        s = float(size_divisible)
        canvas = (int(math.ceil(mh / s) * s), int(math.ceil(mw / s) * s))
    plans = []
    for (h, w), (rh, rw) in zip(sizes, resized):
        dh = int(round((canvas[0] - rh) / 2 - 0.1))
        dw = int(round((canvas[1] - rw) / 2 - 0.1))
        plans.append(LetterboxPlan((h, w), (rh, rw), canvas, (dh, dw)))
    return plans


def letterbox_batch(images: torch.Tensor, plan: LetterboxPlan,
                    fill: float = 114.0 / 255.0) -> torch.Tensor:
    """Letterbox a same-size float batch (B, H, W, 3) onto (B, ch, cw, 3):
    bilinear resize with half-pixel centres, no antialias, then a filled
    canvas.  The result is a channels_last NCHW tensor seen as NHWC."""
    b, _, _, c = images.shape
    rh, rw = plan.resized_hw
    ch, cw = plan.canvas_hw
    dh, dw = plan.offset_hw
    x = images.permute(0, 3, 1, 2)
    if (rh, rw) != tuple(x.shape[2:]):
        x = F.interpolate(x, size=(rh, rw), mode="bilinear", align_corners=False, antialias=False)
    canvas = torch.full((b, c, ch, cw), fill, dtype=images.dtype, device=images.device)
    canvas = canvas.contiguous(memory_format=torch.channels_last)
    canvas[:, :, dh:dh + rh, dw:dw + rw] = x
    return canvas.permute(0, 2, 3, 1)


def letterbox_images(images: Sequence[torch.Tensor], plans: Sequence[LetterboxPlan],
                     fill: float = 114.0 / 255.0) -> torch.Tensor:
    """Letterbox float images (H_i, W_i, 3) of any sizes, each by its plan,
    into its slice of one (B, ch, cw, 3) canvas (the plans share
    ``canvas_hw``, as ``make_plan`` with ``fixed_shape`` makes them): the
    resize of ``letterbox_batch``, so each slice equals the image's own
    ``letterbox_batch`` bit for bit.  Channels_last NCHW seen as NHWC."""
    ch, cw = plans[0].canvas_hw
    if any(p.canvas_hw != (ch, cw) for p in plans):
        raise ValueError(f"plans with different canvases: {sorted({p.canvas_hw for p in plans})}")
    im0 = images[0]
    canvas = torch.full((len(images), im0.shape[-1], ch, cw), fill, dtype=im0.dtype,
                        device=im0.device).contiguous(memory_format=torch.channels_last)
    for i, (im, plan) in enumerate(zip(images, plans)):
        rh, rw = plan.resized_hw
        dh, dw = plan.offset_hw
        x = im.permute(2, 0, 1)[None]
        if (rh, rw) != tuple(x.shape[2:]):
            x = F.interpolate(x, size=(rh, rw), mode="bilinear", align_corners=False,
                              antialias=False)
        canvas[i, :, dh:dh + rh, dw:dw + rw] = x[0]
    return canvas.permute(0, 2, 3, 1)


def _bilinear_taps(n_out: int, n_in: int):
    """Half-pixel bilinear source taps along one axis: (lower index, upper
    index, weight of the upper), source coordinates clamped at 0 as
    ``F.interpolate(align_corners=False)`` clamps them."""
    src = np.maximum((np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5, 0.0)
    lo = np.minimum(np.floor(src).astype(np.int64), n_in - 1)
    hi = np.minimum(lo + 1, n_in - 1)
    return lo, hi, (src - lo).astype(np.float32)


def letterbox_numpy(
    image: np.ndarray,
    canvas_hw: Tuple[int, int],
    min_size: int = 640,
    max_size: int = 640,
    fill: float = 114.0 / 255.0,
) -> np.ndarray:
    """Host letterbox of one HWC image onto a ``canvas_hw`` canvas, in the
    image's dtype: the plan of ``make_plan`` and a half-pixel bilinear
    resize without antialias in float32 numpy (the resize of
    ``letterbox_batch``; no OpenCV)."""
    h, w = image.shape[:2]
    rh, rw = resize_shape(h, w, min_size, max_size)
    x = np.asarray(image, np.float32)
    if (rh, rw) != (h, w):
        y0, y1, ly = _bilinear_taps(rh, h)
        x0, x1, lx = _bilinear_taps(rw, w)
        top = x[y0][:, x0] * (1 - lx)[None, :, None] + x[y0][:, x1] * lx[None, :, None]
        bot = x[y1][:, x0] * (1 - lx)[None, :, None] + x[y1][:, x1] * lx[None, :, None]
        x = top * (1 - ly)[:, None, None] + bot * ly[:, None, None]
    ch, cw = canvas_hw
    dh = int(round((ch - rh) / 2 - 0.1))
    dw = int(round((cw - rw) / 2 - 0.1))
    canvas = np.full((ch, cw, image.shape[-1]), fill, image.dtype)
    canvas[dh:dh + rh, dw:dw + rw] = x.astype(image.dtype)
    return canvas


def scale_coords_back(boxes: torch.Tensor, canvas_hw: Tuple[int, int],
                      orig_hw: torch.Tensor) -> torch.Tensor:
    """xyxy boxes on the canvas -> original image coordinates (gain and pad
    recomputed from the sizes, no rounding).  orig_hw (..., 2) f32
    broadcasts against boxes[..., 0]."""
    ch, cw = float(canvas_hw[0]), float(canvas_hw[1])
    oh = orig_hw[..., 0]
    ow = orig_hw[..., 1]
    gain = torch.minimum(ch / oh, cw / ow)
    pad_x = (cw - ow * gain) * 0.5
    pad_y = (ch - oh * gain) * 0.5
    x1 = (boxes[..., 0] - pad_x) / gain
    y1 = (boxes[..., 1] - pad_y) / gain
    x2 = (boxes[..., 2] - pad_x) / gain
    y2 = (boxes[..., 3] - pad_y) / gain
    return torch.stack([x1, y1, x2, y2], dim=-1)
