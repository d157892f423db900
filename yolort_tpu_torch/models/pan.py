"""Path Aggregation Network neck, r6.0 without P6.

Port of ``yolort_tpu/models/pan.py``: the first inner block is SPP (the
r6.0 layout), the rest are C3 / Conv.  ``inner`` and ``layer`` children
carry the JAX params keys (the upsample slots "2" and "5" hold no params).
On an int8 model the features are ``QTensor``s and the concats stay int8.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from yolort_tpu_torch.models.darknet import depth_gain
from yolort_tpu_torch.ops.blocks import C3, SPP, Conv, _qconcat, upsample2x


class PathAggregationNetwork(nn.Module):
    """PANet over 3 feature levels; ``in_channels`` lowest stride first."""

    def __init__(self, in_channels: Sequence[int], depth_multiple: float, *, gen: torch.Generator):
        super().__init__()
        ch = tuple(in_channels)
        if len(ch) != 3:
            raise ValueError(f"PAN needs 3 channel taps, got {ch}")
        dg = depth_gain(3, depth_multiple)
        self.inner = nn.ModuleDict({
            "0": SPP(ch[2], ch[2], gen=gen),
            "1": Conv(ch[2], ch[1], 1, 1, gen=gen),
            "3": C3(ch[2], ch[1], n=dg, shortcut=False, gen=gen),
            "4": Conv(ch[1], ch[0], 1, 1, gen=gen),
        })
        self.layer = nn.ModuleList([
            C3(ch[1], ch[0], n=dg, shortcut=False, gen=gen),
            Conv(ch[0], ch[0], 3, 2, gen=gen),
            C3(ch[1], ch[1], n=dg, shortcut=False, gen=gen),
            Conv(ch[1], ch[1], 3, 2, gen=gen),
            C3(2 * ch[1], ch[2], n=dg, shortcut=False, gen=gen),
        ])

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """feats: backbone taps (P3, P4, P5); returns one output per level,
        lowest stride first."""
        p3, p4, p5 = feats
        inner = self.inner
        top = inner["1"](inner["0"](p5))
        mid = inner["4"](inner["3"](_qconcat([upsample2x(top), p4])))
        low = _qconcat([upsample2x(mid), p3])
        layer = self.layer
        out3 = layer[0](low)
        out4 = layer[2](_qconcat([layer[1](out3), mid]))
        out5 = layer[4](_qconcat([layer[3](out4), top]))
        return out3, out4, out5
