"""Path Aggregation Network neck, with the P6 level and the TAN variant.

Port of ``yolort_tpu/models/pan.py``: the first inner block is SPP in
r6.0, a C3 / BottleneckCSP in r4.0 / r3.1, or a C3TR (``first_inner=
"c3tr"``, the TAN variant); the rest are C3 / BottleneckCSP and Conv.
With ``use_p6`` two ``p6`` blocks make a fourth level from the last
backbone tap, and the walks down and up the pyramid take one more step.
``inner``, ``layer`` and ``p6`` children carry the JAX params keys (the
upsample slots "2", "5" and "8" hold no params).  On an int8 model the
features are ``QTensor``s and the concats stay int8.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn

from yolort_tpu_torch.models.darknet import depth_gain
from yolort_tpu_torch.ops.blocks import (
    C3, C3TR, SPP, BottleneckCSP, Conv, _qconcat, act_for_version, upsample2x,
)


class PathAggregationNetwork(nn.Module):
    """PANet over 3 feature levels, or 4 with ``use_p6``; ``in_channels``
    lowest stride first, one per output level."""

    def __init__(self, in_channels: Sequence[int], depth_multiple: float, version: str = "r6.0",
                 use_p6: bool = False, first_inner: str = "auto", *, gen: torch.Generator):
        super().__init__()
        ch = tuple(in_channels)
        if len(ch) != (4 if use_p6 else 3):
            raise ValueError(f"PAN{' with P6' if use_p6 else ''} needs {4 if use_p6 else 3} "
                             f"channel taps, got {ch}")
        if first_inner not in ("auto", "c3tr"):
            raise ValueError(f"first_inner must be 'auto' or 'c3tr', got {first_inner!r}")
        act = act_for_version(version)
        # the PAN's blocks are r4.0's in r6.0 too
        block = BottleneckCSP if version == "r3.1" else C3
        dg = depth_gain(3, depth_multiple)
        if use_p6:
            self.p6 = nn.ModuleList([Conv(ch[2], ch[3], 3, 2, act=act, gen=gen),
                                     block(ch[3], ch[3], n=dg, gen=gen)])
        if first_inner == "c3tr":
            init = C3TR(ch[-1], ch[-1], n=dg, shortcut=False, gen=gen)
        elif version == "r6.0":
            init = SPP(ch[-1], ch[-1], act=act, gen=gen)
        else:
            init = block(ch[-1], ch[-1], n=dg, shortcut=False, gen=gen)
        inner = {"0": init}
        if use_p6:
            inner["1"] = Conv(ch[-1], ch[2], 1, 1, act=act, gen=gen)
            inner["3"] = block(ch[1] + ch[-1], ch[2], n=dg, shortcut=False, gen=gen)
        top = len(inner) + (1 if use_p6 else 0)  # the first key of the P5 pyramid's Conv
        inner[str(top)] = Conv(ch[2], ch[1], 1, 1, act=act, gen=gen)
        inner[str(top + 2)] = block(2 * ch[1] if use_p6 else ch[-1], ch[1], n=dg, shortcut=False,
                                    gen=gen)
        inner[str(top + 3)] = Conv(ch[1], ch[0], 1, 1, act=act, gen=gen)
        self.inner = nn.ModuleDict(inner)
        layer = [
            block(ch[1], ch[0], n=dg, shortcut=False, gen=gen),
            Conv(ch[0], ch[0], 3, 2, act=act, gen=gen),
            block(ch[1], ch[1], n=dg, shortcut=False, gen=gen),
            Conv(ch[1], ch[1], 3, 2, act=act, gen=gen),
            block(2 * ch[1], ch[2], n=dg, shortcut=False, gen=gen),
        ]
        if use_p6:
            layer += [Conv(ch[2], ch[2], 3, 2, act=act, gen=gen),
                      block(2 * ch[2], ch[-1], n=dg, shortcut=False, gen=gen)]
        self.layer = nn.ModuleList(layer)

    def forward(self, feats: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """feats: backbone taps (P3, P4, P5); returns one output per level,
        lowest stride first."""
        x = list(feats)
        if "p6" in self._modules:
            y = x[-1]
            for b in self.p6:
                y = b(y)
            x.append(y)
        n = len(x)
        inner, layer = self.inner, self.layer
        # down the pyramid: inner blocks 3i and 3i + 1, then upsample + concat
        inners = []
        last = x[-1]
        for i in range(n - 1):
            last = inner[str(3 * i + 1)](inner[str(3 * i)](last))
            inners.insert(0, last)
            last = _qconcat([upsample2x(last), x[n - i - 2]])
        inners.insert(0, last)
        # up the pyramid: layer blocks 2i + 1 (downsample) and 2i + 2
        last = layer[0](inners[0])
        results = [last]
        for i in range(n - 1):
            last = layer[2 * i + 2](_qconcat([layer[2 * i + 1](last), inners[i + 1]]))
            results.append(last)
        return tuple(results)
