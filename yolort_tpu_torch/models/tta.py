"""Test-time augmentation (TTA).

Port of ``yolort_tpu/models/tta.py`` (the reference's ``scale_img`` and
augmented inference): the model runs on rescaled and flipped variants of
a batch, every variant's decoded predictions are mapped back to the base
frame, and one postprocess keeps the best of the pool.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from yolort_tpu_torch.ops.nms import Detections


def scale_img(x: torch.Tensor, ratio: float, stride: int = 32,
              fill: float = 114.0 / 255.0) -> torch.Tensor:
    """A (B, H, W, C) batch resized by ``ratio`` to (int(H * ratio),
    int(W * ratio)) (bilinear, half-pixel centres, no antialiasing: the
    JAX package's resize) and padded at the bottom and right with ``fill``
    up to multiples of ``stride``.  ``ratio`` 1.0 returns ``x``."""
    if ratio == 1.0:
        return x
    _, h, w, _ = x.shape
    nh, nw = int(h * ratio), int(w * ratio)
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(nh, nw), mode="bilinear", align_corners=False,
                      antialias=False)
    y = F.pad(y, (0, -nw % stride, 0, -nh % stride), value=fill)
    return y.permute(0, 2, 3, 1)


def tta_decode(model, images: torch.Tensor, *, scales: Sequence[float] = (1.0, 0.83, 0.67),
               flips: Sequence[bool] = (False, True, False)) -> torch.Tensor:
    """A ``Detector``'s decoded predictions on letterboxed ``images`` (B, H,
    W, 3) pooled over the (scale, horizontal flip) variants, in the base
    frame: (B, sum of the variants' anchors, 5+nc) f32.  Each variant's
    boxes are divided by its scale, a flipped one's centre x mirrored to
    W - cx."""
    w = images.shape[2]
    preds = []
    for ratio, flip in zip(scales, flips):
        x = scale_img(torch.flip(images, dims=[2]) if flip else images, ratio)
        pred = model.decode(x)  # (B, Na, 5+nc) in the scaled frame's pixels
        box = pred[..., :4] / ratio
        if flip:
            box = torch.cat([w - box[..., :1], box[..., 1:]], dim=-1)
        preds.append(torch.cat([box, pred[..., 4:]], dim=-1))
    return torch.cat(preds, dim=1)


def tta_inference(model, images: torch.Tensor, *, scales: Sequence[float] = (1.0, 0.83, 0.67),
                  flips: Sequence[bool] = (False, True, False)) -> Detections:
    """Detections of ``tta_decode``'s pool, in the base frame, under
    ``model``'s thresholds and ``row_gather`` route."""
    return model.postprocess_decoded(tta_decode(model, images, scales=scales, flips=flips))
