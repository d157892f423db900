"""YOLOv5 with a MobileNetV3-Small + FPN backbone: the "bring your own
backbone" model.

Port of ``yolort_tpu/models/yolo_lite.py``: a MobileNetV3-Small feature
extractor written here (no torchvision), a feature pyramid with a
max-pool extra level (four levels, strides 8-64) and the YOLO head, with
the postprocess of ``Detector``.  Child names are the JAX params keys.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from yolort_tpu_torch.models.head import P6_ANCHOR_GRIDS, P6_STRIDES, YOLOHead
from yolort_tpu_torch.models.yolo import Detector, resolve_device
from yolort_tpu_torch.ops.blocks import Conv, Conv2dOnly, InvertedResidual

# MobileNetV3-Small's blocks: (kernel, expansion, out, SE, act, stride)
_MNV3_SMALL = (
    (3, 16, 16, True, "relu", 2),
    (3, 72, 24, False, "relu", 2),
    (3, 88, 24, False, "relu", 1),
    (5, 96, 40, True, "hardswish", 2),
    (5, 240, 40, True, "hardswish", 1),
    (5, 240, 40, True, "hardswish", 1),
    (5, 120, 48, True, "hardswish", 1),
    (5, 144, 48, True, "hardswish", 1),
    (5, 288, 96, True, "hardswish", 2),
    (5, 576, 96, True, "hardswish", 1),
    (5, 576, 96, True, "hardswish", 1),
)


class MobileNetV3Small(nn.Module):
    """Feature extractor: a stride-2 hardswish stem and the 11 blocks,
    children "0".."11"; returns the taps after layers 3, 8 and 11
    (strides 8, 16, 32)."""

    returned_layers = (3, 8, 11)
    out_channels = (24, 48, 96)

    def __init__(self, *, gen: torch.Generator):
        super().__init__()
        self.add_module("0", Conv(3, 16, 3, 2, act="hardswish", gen=gen))
        cin = 16
        for i, (k, exp, cout, se, act, s) in enumerate(_MNV3_SMALL, start=1):
            self.add_module(str(i), InvertedResidual(cin, exp, cout, k, s, use_se=se, act=act,
                                                     gen=gen))
            cin = cout

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        feats = []
        for i, m in enumerate(self.children()):
            x = m(x)
            if i in self.returned_layers:
                feats.append(x)
        return tuple(feats)


class FPN(nn.Module):
    """Feature pyramid: lateral 1x1 convs, a top-down sum with a nearest
    resize, 3x3 smoothing convs; then an extra level, the stride-2 'SAME'
    max pool of window 1 of the last output (its every other row and
    column: ceil(h/2) x ceil(w/2), no padding)."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 128, *,
                 gen: torch.Generator):
        super().__init__()
        self.lateral = nn.ModuleList(Conv2dOnly(c, out_channels, 1, gen=gen) for c in in_channels)
        self.smooth = nn.ModuleList(Conv2dOnly(out_channels, out_channels, 3, gen=gen)
                                    for _ in in_channels)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        laterals = [m(f) for m, f in zip(self.lateral, feats)]
        outs = [laterals[-1]]
        for lat in laterals[-2::-1]:
            # JAX's 'nearest' resize samples at half-pixel centres: torch's
            # 'nearest-exact' (they differ from 'nearest' unless the ratio is 2)
            up = F.interpolate(outs[0], size=lat.shape[2:], mode="nearest-exact")
            outs.insert(0, lat + up)
        outs = [m(o) for m, o in zip(self.smooth, outs)]
        return (*outs, F.max_pool2d(outs[-1], 1, 2))


class MobileNetBackboneWithFPN(nn.Module):
    """MobileNetV3-Small ``body`` and its ``fpn``: four levels of
    ``out_channels_fpn`` channels."""

    def __init__(self, out_channels_fpn: int = 128, *, gen: torch.Generator):
        super().__init__()
        self.body = MobileNetV3Small(gen=gen)
        self.fpn = FPN(self.body.out_channels, out_channels_fpn, gen=gen)
        self.out_channels = (out_channels_fpn,) * 4

    def forward(self, x):
        return self.fpn(self.body(x))


class YOLOLite(Detector):
    """YOLO on the MobileNetV3-Small FPN backbone: four levels at strides
    8-64 with the P6 anchors unless given; ``postprocess`` holds
    ``Detector``'s keywords.  Weights are drawn from
    ``torch.Generator(seed)``, then the module moves to ``device`` (the
    card unless the caller passes ``"cpu"``) and ``dtype``."""

    def __init__(
        self,
        fpn_channels: int = 128,
        *,
        device="cuda",
        dtype: torch.dtype = torch.float32,
        num_classes: int = 80,
        strides: Optional[Sequence[int]] = None,
        anchor_grids: Optional[Sequence[Sequence[float]]] = None,
        seed: int = 0,
        **postprocess,
    ):
        device = resolve_device(device)
        super().__init__(num_classes=num_classes, strides=strides or P6_STRIDES,
                         anchor_grids=anchor_grids or P6_ANCHOR_GRIDS, **postprocess)
        gen = torch.Generator().manual_seed(seed)
        self.backbone = MobileNetBackboneWithFPN(fpn_channels, gen=gen)
        self.head = YOLOHead(self.backbone.out_channels, self.num_anchors, self.strides,
                             num_classes, gen=gen)
        self.place(device, dtype)

    def features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """images (B, H, W, 3) letterboxed float -> the four FPN levels."""
        return self.backbone(self.nchw(images))


def yolov5_mobilenet_v3_small_fpn(pretrained: bool = False, progress: bool = True,
                                  num_classes: int = 80, **kwargs) -> YOLOLite:
    """The yolo_lite model (``kwargs`` go to ``YOLOLite``).  No pretrained
    weights exist, upstream either: ``pretrained=True`` raises."""
    if pretrained:
        raise NotImplementedError("no pretrained yolo_lite weights exist (same upstream)")
    return YOLOLite(num_classes=num_classes, **kwargs)
