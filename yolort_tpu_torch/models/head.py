"""YOLO detection head and anchor properties.

Port of ``yolort_tpu/models/head.py``: per-level 1x1 convs producing
A*(5+nc) channels with the prior-probability bias init, the COCO and P6
anchors, the flat-index anchor arithmetic the postprocess uses (and the
tables it replaces, ``anchor_tables``), ``flatten_heads``, and the full
decode (``concat_pred_logits``: everything but the NMS).  Head
outputs are returned NHWC, (B, H, W, A*(5+nc)), as in the JAX package.
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
# P6 defaults
P6_STRIDES = (8, 16, 32, 64)
P6_ANCHOR_GRIDS = (
    (19, 27, 44, 40, 38, 94),
    (96, 68, 86, 152, 180, 137),
    (140, 301, 303, 264, 238, 542),
    (436, 615, 739, 380, 925, 792),
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
        self.strides = tuple(strides)
        no = num_classes + 5
        for i, ch in enumerate(in_channels):
            self.add_module(str(i), Conv2dOnly(ch, no * num_anchors, 1, bias=True, gen=gen))
        self.add_prior_bias()

    def add_prior_bias(self) -> None:
        """The prior-probability bias on the drawn one: obj log(8 / (640/s)^2),
        cls log(0.6/(nc-1))."""
        no = self.num_classes + 5
        with torch.no_grad():
            for conv, s in zip(self.children(), self.strides):
                b = conv.bias.view(self.num_anchors, no)
                b[:, 4] += math.log(8 / (640 / s) ** 2)
                b[:, 5:] += math.log(0.6 / (self.num_classes - 0.999999))

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Channels-last NCHW features -> per-level logits, NHWC contiguous:
        a channels_last conv output seen as NHWC already is, so
        ``contiguous`` copies nothing when the model runs; where
        ``torch.export`` traces the conv on the card its fake output is not
        channels_last, and the traced program copies here."""
        return [conv(x).permute(0, 2, 3, 1).contiguous() for conv, x in zip(self.children(), feats)]


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


def make_grids_and_shifts(
    grid_sizes: Sequence[Tuple[int, int]],
    anchor_grids: Sequence[Sequence[float]],
    device="cpu",
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per level, the anchor cell centres (x, y) and the anchors' (w, h)
    in pixels, each (H*W*A, 2) f32 in the NHWA order of the head outputs."""
    num_anchors = len(anchor_grids[0]) // 2
    grids, shifts = [], []
    for (h, w), ag in zip(grid_sizes, anchor_grids):
        ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        grid = torch.stack([xs, ys], dim=-1).float()[:, :, None, :].expand(h, w, num_anchors, 2)
        anchors = torch.tensor(ag, dtype=torch.float32).reshape(num_anchors, 2)
        grids.append(grid.reshape(-1, 2).to(device))
        shifts.append(anchors.expand(h, w, num_anchors, 2).reshape(-1, 2).to(device))
    return grids, shifts


def decode_level(head_logits: torch.Tensor, grid: torch.Tensor, shift: torch.Tensor,
                 stride: float, num_anchors: int) -> torch.Tensor:
    """sigmoid and box decode of one level: (N, H, W, A*K) -> (N, H*W*A, K)
    f32, columns [cx, cy, w, h, obj, cls...]; xy = (2 sig - 0.5 + grid) *
    stride, wh = (2 sig)^2 * anchor."""
    n, h, w, c = head_logits.shape
    sig = torch.sigmoid(head_logits.reshape(n, h * w * num_anchors, c // num_anchors).float())
    xy = (sig[..., 0:2] * 2.0 - 0.5 + grid) * stride
    wh = (sig[..., 2:4] * 2.0) ** 2 * shift
    return torch.cat([xy, wh, sig[..., 4:]], dim=-1)


def flatten_heads(head_outputs: Sequence[torch.Tensor], num_anchors: int) -> torch.Tensor:
    """Per-level logits (B, H, W, A*K) concatenated as (B, total_anchors, K)
    in the model dtype (no decode, no upcast), anchors in the order of
    ``anchor_props_from_index``."""
    return torch.cat([ho.reshape(ho.shape[0], -1, ho.shape[3] // num_anchors)
                      for ho in head_outputs], dim=1)


def anchor_tables(
    grid_sizes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    anchor_grids: Sequence[Sequence[float]],
    device="cpu",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-anchor (grid_xy, anchor_wh, stride) tables, (total_anchors, 2),
    (total_anchors, 2) and (total_anchors,) f32, in ``flatten_heads``
    order: the values ``anchor_props_from_index`` computes from the
    index."""
    grids, shifts = make_grids_and_shifts(grid_sizes, anchor_grids, device)
    num_anchors = len(anchor_grids[0]) // 2
    stride = torch.cat([torch.full((h * w * num_anchors,), float(st), device=device)
                        for (h, w), st in zip(grid_sizes, strides)])
    return torch.cat(grids), torch.cat(shifts), stride


def concat_pred_logits(
    head_outputs: Sequence[torch.Tensor],
    grid_sizes: Sequence[Tuple[int, int]],
    strides: Sequence[int],
    anchor_grids: Sequence[Sequence[float]],
) -> torch.Tensor:
    """Every level decoded and concatenated: (N, total_anchors, 5+nc)."""
    num_anchors = len(anchor_grids[0]) // 2
    grids, shifts = make_grids_and_shifts(grid_sizes, anchor_grids, head_outputs[0].device)
    return torch.cat([decode_level(ho, g, s, float(st), num_anchors)
                      for ho, g, s, st in zip(head_outputs, grids, shifts, strides)], dim=1)
