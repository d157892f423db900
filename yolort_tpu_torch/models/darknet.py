"""CSPDarknet backbones, r3.1 / r4.0 / r6.0.

Port of ``yolort_tpu/models/darknet.py``: r6.0 has a 6x6/s2/p2 conv stem,
three Conv + C3 stages and a tail Conv + C3; r3.1 and r4.0 a Focus stem,
stages [3, 9, 9] (BottleneckCSP in r3.1, C3 in r4.0) and a tail Conv +
SPP, Hardswish in r3.1.  Children are named "0".."8" as the JAX params
tree is; the feature taps are layers (4, 6, 8), strides 8/16/32.  The
TPU-only space-to-depth stem (``stem_s2d``) is not ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from yolort_tpu_torch.ops.blocks import C3, SPP, BottleneckCSP, Conv, Focus, act_for_version

VERSIONS = ("r3.1", "r4.0", "r6.0")


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
    """CSPDarknet feature extractor; ``last_channel`` is 768 under a P6
    PAN."""

    returned_layers = (4, 6, 8)

    def __init__(self, depth_multiple: float, width_multiple: float, version: str = "r6.0",
                 last_channel: int = 1024, *, gen: torch.Generator):
        super().__init__()
        if version not in VERSIONS:
            raise ValueError(f"version must be one of {VERSIONS}, got {version!r}")
        dm, wm = depth_multiple, width_multiple
        act = act_for_version(version)
        block = BottleneckCSP if version == "r3.1" else C3
        is_v6 = version == "r6.0"
        cin = make_divisible(64 * wm)
        layers = [Conv(3, cin, k=6, s=2, p=2, act=act, gen=gen) if is_v6
                  else Focus(3, cin, k=3, act=act, gen=gen)]
        for rep, cout in zip((3, 6, 9) if is_v6 else (3, 9, 9), (128, 256, 512)):
            cout = make_divisible(cout * wm)
            layers.append(Conv(cin, cout, k=3, s=2, act=act, gen=gen))
            layers.append(block(cout, cout, n=depth_gain(rep, dm), gen=gen))
            cin = cout
        last = make_divisible(last_channel * wm)
        layers.append(Conv(cin, last, k=3, s=2, act=act, gen=gen))
        layers.append(C3(last, last, n=depth_gain(3, dm), act=act, gen=gen) if is_v6
                      else SPP(last, last, act=act, gen=gen))
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
