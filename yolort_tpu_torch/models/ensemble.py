"""Model ensembling.

Port of ``yolort_tpu/models/ensemble.py`` (the reference's NMS-merge
ensemble): several detection models run on the same batch, their decoded
predictions are pooled along the anchor axis, and one postprocess keeps
the best of the union.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from yolort_tpu_torch.models.yolo import Detector
from yolort_tpu_torch.ops.nms import Detections
from yolort_tpu_torch.utils.profiling import span


class Ensemble(nn.Module):
    """Ensemble of detection models (``Detector``s) that share
    ``num_classes``; the first is the lead, whose thresholds and
    ``row_gather`` route the pooled postprocess takes, as they stand at
    each call.  ``YOLOv5(model=Ensemble(...))`` serves it."""

    def __init__(self, models: Sequence[Detector]):
        super().__init__()
        if not models:
            raise ValueError("an ensemble needs at least one model")
        classes = {m.num_classes for m in models}
        if len(classes) != 1:
            raise ValueError(f"ensemble members must share num_classes, got {sorted(classes)}")
        self.members = nn.ModuleList(models)
        self.num_classes = models[0].num_classes

    def decode(self, images: torch.Tensor) -> torch.Tensor:
        """Every member's decoded predictions concatenated along the anchor
        axis: (B, sum of the members' anchors, 5+nc) f32."""
        return torch.cat([m.decode(images) for m in self.members], dim=1)

    def forward(self, images: torch.Tensor) -> Detections:
        """images (B, H, W, 3) letterboxed -> padded Detections of the pooled
        predictions, canvas coordinates."""
        with span("network"):
            pred = self.decode(images)
        return self.members[0].postprocess_decoded(pred)
