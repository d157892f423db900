"""CSPDarknet r6.0 backbone.

Port of ``yolort_tpu/models/darknet.py`` for r6.0: a 6x6/s2/p2 conv stem,
three Conv + C3 stages, a tail Conv + C3.  Children are named "0".."9" as
the JAX params tree is; the feature taps are layers (4, 6, 8), strides
8/16/32.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from yolort_tpu_torch.ops.blocks import C3, Conv


def make_divisible(v: float, divisor: int = 8, min_value: Optional[int] = None) -> int:
    """Channel rounding rule."""
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def depth_gain(n: int, depth_multiple: float) -> int:
    return max(round(n * depth_multiple), 1)


class DarkNet(nn.Module):
    """CSPDarknet r6.0 feature extractor."""

    returned_layers = (4, 6, 8)

    def __init__(self, depth_multiple: float, width_multiple: float, *, gen: torch.Generator):
        super().__init__()
        dm, wm = depth_multiple, width_multiple
        cin = make_divisible(64 * wm)
        layers = [Conv(3, cin, k=6, s=2, p=2, gen=gen)]
        for rep, cout in zip((3, 6, 9), (128, 256, 512)):
            cout = make_divisible(cout * wm)
            layers.append(Conv(cin, cout, k=3, s=2, gen=gen))
            layers.append(C3(cout, cout, n=depth_gain(rep, dm), gen=gen))
            cin = cout
        last = make_divisible(1024 * wm)
        layers.append(Conv(cin, last, k=3, s=2, gen=gen))
        layers.append(C3(last, last, n=depth_gain(3, dm), gen=gen))
        for i, layer in enumerate(layers):
            self.add_module(str(i), layer)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """x: (B, 3, H, W) -> (P3, P4, P5) at strides (8, 16, 32)."""
        feats = []
        for i, layer in enumerate(self.children()):
            x = layer(x)
            if i in self.returned_layers:
                feats.append(x)
        return tuple(feats)
