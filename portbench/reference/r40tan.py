"""The reference network of yolov5ts, ultralytics v5.0's
``models/hub/yolov5s-transformer.yaml``: the r4.0 yolov5s layout (Focus
stem, C3 stages, SPP at flat 8) with flat layer 9 a ``C3TR`` in place of
the head's first ``C3``, through the contract in ``portbench/spec.py``.

The classes follow v5.0 ``models/common.py`` (``Focus``, ``SPP``,
``C3TR``, ``TransformerBlock``, ``TransformerLayer``) and
``models/yolo.py``'s flat ``Sequential``; the attention is
``nn.MultiheadAttention`` as ultralytics calls it, tokens first.  Two
departures, neither a change of the function:

* ``TransformerBlock`` keeps no ``conv`` where its widths agree (v5.0
  keeps ``None`` there too), and reads the map's height and width
  under those names;
* each ``TransformerLayer`` multiplies its q, k and v projections by
  ``qkv_gain``, the configuration's ``assumed`` ``attention_qkv_gain``
  (a power of 2, so the product is exact).  The seeded draw
  (``weights.make``: U(-1, 1)/sqrt(fan_in), each Linear shrinking its
  input's norm by sqrt(3)) leaves the scaled scores at std 0.01, a
  softmax within a few % of uniform, and the attention's output at a
  few % of the residual's norm, so the block adds nearly a constant.
  A gain of 8 gives scores of std 0.46 (a largest probability 10 times
  uniform) and an output at 0.6 of the residual's norm, as in a
  trained layer (measured on this network at a 640 canvas).  ``save_checkpoint``
  writes the q, k and v weights times the gain, so the checkpoint holds
  the very function the reference computes, as plain ultralytics
  modules.
"""

from __future__ import annotations

import copy

import torch
from torch import nn

from portbench.reference import models
from portbench.reference.models import FC3, FConcat, FConv, FDetect


def _make_divisible(v, d=8):
    nv = max(d, int(v + d / 2) // d * d)
    return nv + d if nv < 0.9 * v else nv


class FFocus(nn.Module):
    def __init__(self, c1, c2, k=1):
        super().__init__()
        self.conv = FConv(c1 * 4, c2, k, 1)

    def forward(self, x):
        return self.conv(torch.cat(
            [x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2], x[..., 1::2, 1::2]], 1))


class FSPP(nn.Module):
    def __init__(self, c1, c2, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = FConv(c1, c_, 1, 1)
        self.cv2 = FConv(c_ * (len(k) + 1), c2, 1, 1)
        self.m = nn.ModuleList(nn.MaxPool2d(kernel_size=x, stride=1, padding=x // 2) for x in k)

    def forward(self, x):
        x = self.cv1(x)
        return self.cv2(torch.cat([x] + [m(x) for m in self.m], 1))


class FTransformerLayer(nn.Module):
    def __init__(self, c, num_heads, qkv_gain=1.0):
        super().__init__()
        self.q = nn.Linear(c, c, bias=False)
        self.k = nn.Linear(c, c, bias=False)
        self.v = nn.Linear(c, c, bias=False)
        self.ma = nn.MultiheadAttention(embed_dim=c, num_heads=num_heads)
        self.fc1 = nn.Linear(c, c, bias=False)
        self.fc2 = nn.Linear(c, c, bias=False)
        self.qkv_gain = float(qkv_gain)

    def forward(self, x):
        g = self.qkv_gain
        x = self.ma(self.q(x) * g, self.k(x) * g, self.v(x) * g)[0] + x
        return self.fc2(self.fc1(x)) + x


class FTransformerBlock(nn.Module):
    def __init__(self, c1, c2, num_heads, num_layers, qkv_gain=1.0):
        super().__init__()
        self.conv = None if c1 == c2 else FConv(c1, c2)
        self.linear = nn.Linear(c2, c2)
        self.tr = nn.Sequential(*[FTransformerLayer(c2, num_heads, qkv_gain)
                                  for _ in range(num_layers)])
        self.c2 = c2

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        b, _, h, w = x.shape
        p = x.flatten(2).unsqueeze(0).transpose(0, 3).squeeze(3)   # (L, B, C)
        return self.tr(p + self.linear(p)).unsqueeze(3).transpose(0, 3).reshape(b, self.c2, h, w)


class FC3TR(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=True, e=0.5, qkv_gain=1.0):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = FConv(c1, c_, 1, 1)
        self.cv2 = FConv(c1, c_, 1, 1)
        self.cv3 = FConv(2 * c_, c2, 1)
        self.m = FTransformerBlock(c_, c_, 4, n, qkv_gain)

    def forward(self, x):
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class FModelTAN(nn.Module):
    """Flat ``Sequential`` lookalike of v5.0's ``Model`` built from
    ``yolov5s-transformer.yaml`` at any depth and width multiple."""

    def __init__(self, nc=80, dm=0.33, wm=0.5, anchors=None, qkv_gain=1.0):
        super().__init__()
        c = {k: _make_divisible(k * wm) for k in (64, 128, 256, 512, 1024)}

        def dg(n):
            return max(round(n * dm), 1)

        layers = [
            FFocus(3, c[64], 3),                                   # 0
            FConv(c[64], c[128], 3, 2),                            # 1
            FC3(c[128], c[128], dg(3)),                            # 2
            FConv(c[128], c[256], 3, 2),                           # 3
            FC3(c[256], c[256], dg(9)),                            # 4
            FConv(c[256], c[512], 3, 2),                           # 5
            FC3(c[512], c[512], dg(9)),                            # 6
            FConv(c[512], c[1024], 3, 2),                          # 7
            FSPP(c[1024], c[1024]),                                # 8
            FC3TR(c[1024], c[1024], dg(3), False, qkv_gain=qkv_gain),  # 9
            FConv(c[1024], c[512], 1, 1),                          # 10
            nn.Upsample(scale_factor=2.0, mode="nearest"),         # 11
            FConcat(),                                             # 12
            FC3(c[1024], c[512], dg(3), False),                    # 13
            FConv(c[512], c[256], 1, 1),                           # 14
            nn.Upsample(scale_factor=2.0, mode="nearest"),         # 15
            FConcat(),                                             # 16
            FC3(c[512], c[256], dg(3), False),                     # 17
            FConv(c[256], c[256], 3, 2),                           # 18
            FConcat(),                                             # 19
            FC3(c[512], c[512], dg(3), False),                     # 20
            FConv(c[512], c[512], 3, 2),                           # 21
            FConcat(),                                             # 22
            FC3(c[1024], c[1024], dg(3), False),                   # 23
            FDetect(nc, anchors, (c[256], c[512], c[1024])),       # 24
        ]
        self.model = nn.Sequential(*layers)
        self.model[-1].stride = torch.tensor([8.0, 16.0, 32.0])
        with torch.no_grad():
            self.model[-1].anchors /= self.model[-1].stride.view(-1, 1, 1)
        self.stride = self.model[-1].stride
        self.yaml = {"nc": nc, "depth_multiple": dm, "width_multiple": wm, "anchors": anchors}

    def forward(self, x):
        m = self.model
        p3 = m[4](m[3](m[2](m[1](m[0](x)))))
        p4 = m[6](m[5](p3))
        i10 = m[10](m[9](m[8](m[7](p4))))
        x13 = m[13](m[12]([m[11](i10), p4]))
        i14 = m[14](x13)
        x17 = m[17](m[16]([m[15](i14), p3]))
        x20 = m[20](m[19]([m[18](x17), i14]))
        x23 = m[23](m[22]([m[21](x20), i10]))
        return m[24]([x17, x20, x23])


EXTRA = {
    FFocus: ("models.common", "Focus"),
    FSPP: ("models.common", "SPP"),
    FC3TR: ("models.common", "C3TR"),
    FTransformerBlock: ("models.common", "TransformerBlock"),
    FTransformerLayer: ("models.common", "TransformerLayer"),
    FModelTAN: ("models.yolo", "Model"),
}


def build(cfg: dict) -> nn.Module:
    gain = float(cfg.get("assumed", {}).get("attention_qkv_gain", 1.0))
    return FModelTAN(nc=cfg["nc"], dm=cfg["depth_multiple"], wm=cfg["width_multiple"],
                     anchors=[list(a) for a in cfg["anchors"]], qkv_gain=gain).eval()


head_logits = models.head_logits


@torch.no_grad()
def save_checkpoint(net: nn.Module, path: str) -> None:
    """``net`` as an ultralytics checkpoint, each layer's q, k and v
    weights times its gain (``net`` itself is left as it is)."""
    out = copy.deepcopy(net)
    for layer in out.modules():
        if isinstance(layer, FTransformerLayer):
            for lin in (layer.q, layer.k, layer.v):
                lin.weight.mul_(layer.qkv_gain)
            del layer.qkv_gain
    models.save_checkpoint(out, path, extra=EXTRA)
