"""YOLO detection head and anchor properties.

Port of ``yolort_tpu/models/head.py``: per-level 1x1 convs producing
A*(5+nc) channels with the prior-probability bias init, and the flat-index
anchor arithmetic the postprocess uses.  Head outputs are returned NHWC,
(B, H, W, A*(5+nc)), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from yolort_tpu_torch.ops.blocks import Conv2dOnly

# COCO defaults
DEFAULT_STRIDES = (8, 16, 32)
DEFAULT_ANCHOR_GRIDS = (
    (10, 13, 16, 30, 33, 23),
    (30, 61, 62, 45, 59, 119),
    (116, 90, 156, 198, 373, 326),
)

# logit of the padding lanes of a lane-padded head: sigmoid(-1e4) == 0
PAD_LOGIT = -1.0e4


def padded_num_outputs(num_outputs: int, lane: int = 128) -> int:
    """Smallest lane multiple >= num_outputs (85 -> 128 for nc=80)."""
    return -(-num_outputs // lane) * lane


class YOLOHead(nn.Module):
    """Per-level 1x1 conv producing A*(5+nc) channels; children "0".."L-1"."""

    def __init__(self, in_channels: Sequence[int], num_anchors: int, strides: Sequence[int],
                 num_classes: int, *, gen: torch.Generator):
        super().__init__()
        self.num_anchors = num_anchors
        self.num_classes = num_classes
        no = num_classes + 5
        for i, (ch, s) in enumerate(zip(in_channels, strides)):
            conv = Conv2dOnly(ch, no * num_anchors, 1, bias=True, gen=gen)
            # prior-probability bias: obj log(8 / (640/s)^2), cls log(0.6/(nc-1))
            with torch.no_grad():
                b = conv.bias.view(num_anchors, no)
                b[:, 4] += math.log(8 / (640 / s) ** 2)
                b[:, 5:] += math.log(0.6 / (num_classes - 0.999999))
            self.add_module(str(i), conv)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Channels-last NCHW features -> per-level logits, NHWC."""
        return [conv(x).permute(0, 2, 3, 1) for conv, x in zip(self.children(), feats)]


def anchor_props_from_index(
    idx: torch.Tensor,
    grid_sizes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    anchor_grids: Sequence[Sequence[float]],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(grid_xy, anchor_wh, stride) of flat anchor indices by integer
    arithmetic: index = offset_l + (h * W_l + w) * A + a.  Returns
    (..., 2), (..., 2), (...) f32, bit-identical to the JAX tables."""
    num_anchors = len(anchor_grids[0]) // 2
    f32 = torch.float32
    zeros = torch.zeros(idx.shape, dtype=f32, device=idx.device)
    gx, gy, sw, sh, st = zeros, zeros, zeros, zeros, zeros
    off = 0
    for (h, w), stride_l, ag in zip(grid_sizes, strides, anchor_grids):
        n_l = h * w * num_anchors
        in_l = (idx >= off) & (idx < off + n_l)
        local = idx - off
        a = local % num_anchors
        cell = local // num_anchors
        gx = torch.where(in_l, (cell % w).to(f32), gx)
        gy = torch.where(in_l, (cell // w).to(f32), gy)
        st = torch.where(in_l, float(stride_l), st)
        for ai in range(num_anchors):
            m = in_l & (a == ai)
            sw = torch.where(m, float(ag[2 * ai]), sw)
            sh = torch.where(m, float(ag[2 * ai + 1]), sh)
        off += n_l
    return torch.stack([gx, gy], dim=-1), torch.stack([sw, sh], dim=-1), st
