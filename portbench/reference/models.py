"""Frozen copy of the plain-PyTorch YOLOv5 networks the benchmark's
reference runs: ultralytics' r6.0 layout of ``yolov5s.yaml`` (P3-P5) and
``yolov5s6.yaml`` (P3-P6), in a flat ``model.N`` Sequential with a
``Detect`` head.

The classes and ``randomize_bn_stats`` below are copied verbatim from
``tests/torch_fixture.py`` at commit 2333ff05cfa62090dae0a92b4ed6284716400f9a
(the test oracle of the port), so that a change to the port's tests
cannot move the yardstick.  What follows the copy is the benchmark's own:
the ultralytics module names a checkpoint is pickled under
(``save_checkpoint``) and the raw per-level logits (``head_logits``).
This module imports torch alone: nothing of the program under test.
"""

import sys
import types

import torch
import torch.nn as nn


def _autopad(k, p=None):
    return k // 2 if p is None else p


class FConv(nn.Module):
    def __init__(self, c1, c2, k=1, s=1, p=None, g=1, act="silu"):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, _autopad(k, p), groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3)
        self.act = nn.SiLU() if act == "silu" else nn.Hardswish()

    def forward(self, x):
        return self.act(self.bn(self.conv(x)))


class FBottleneck(nn.Module):
    def __init__(self, c1, c2, shortcut=True, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = FConv(c1, c_, 1, 1)
        self.cv2 = FConv(c_, c2, 3, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class FC3(nn.Module):
    def __init__(self, c1, c2, n=1, shortcut=True, e=0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = FConv(c1, c_, 1, 1)
        self.cv2 = FConv(c1, c_, 1, 1)
        self.cv3 = FConv(2 * c_, c2, 1)
        self.m = nn.Sequential(*[FBottleneck(c_, c_, shortcut, e=1.0) for _ in range(n)])

    def forward(self, x):
        return self.cv3(torch.cat((self.m(self.cv1(x)), self.cv2(x)), 1))


class FSPPF(nn.Module):
    def __init__(self, c1, c2, k=5):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = FConv(c1, c_, 1, 1)
        self.cv2 = FConv(c_ * 4, c2, 1, 1)
        self.m = nn.MaxPool2d(kernel_size=k, stride=1, padding=k // 2)

    def forward(self, x):
        x = self.cv1(x)
        y1 = self.m(x)
        y2 = self.m(y1)
        return self.cv2(torch.cat([x, y1, y2, self.m(y2)], 1))


class FConcat(nn.Module):
    def __init__(self, d=1):
        super().__init__()
        self.d = d

    def forward(self, xs):
        return torch.cat(xs, self.d)


class FDetect(nn.Module):
    def __init__(self, nc, anchors, ch):
        super().__init__()
        self.nc = nc
        self.no = nc + 5
        self.nl = len(anchors)
        self.na = len(anchors[0]) // 2
        self.register_buffer("anchors", torch.tensor(anchors).float().view(self.nl, -1, 2))
        self.m = nn.ModuleList(nn.Conv2d(c, self.no * self.na, 1) for c in ch)

    def forward(self, feats):
        """Returns decoded (bs, total, no) like ultralytics inference."""
        z = []
        for i, x in enumerate(feats):
            x = self.m[i](x)
            bs, _, ny, nx = x.shape
            x = x.view(bs, self.na, self.no, ny, nx).permute(0, 1, 3, 4, 2)
            y = x.sigmoid()
            yv, xv = torch.meshgrid(torch.arange(ny).float(), torch.arange(nx).float())
            grid = torch.stack((xv, yv), 2).view(1, 1, ny, nx, 2)
            anchor_grid = (self.anchors[i] * self.stride[i]).view(1, self.na, 1, 1, 2)
            xy = (y[..., 0:2] * 2 - 0.5 + grid) * self.stride[i]
            wh = (y[..., 2:4] * 2) ** 2 * anchor_grid
            y = torch.cat((xy, wh, y[..., 4:]), 4)
            z.append(y.view(bs, -1, self.no))
        return torch.cat(z, 1)


class FModel(nn.Module):
    """Flat-Sequential DetectionModel lookalike (P5, r6.0 layout)."""

    def __init__(self, nc=7, dm=0.33, wm=0.25, anchors=None):
        super().__init__()
        if anchors is None:
            anchors = [
                [10, 13, 16, 30, 33, 23],
                [30, 61, 62, 45, 59, 119],
                [116, 90, 156, 198, 373, 326],
            ]

        def mdiv(v, d=8):
            nv = max(d, int(v + d / 2) // d * d)
            return nv + d if nv < 0.9 * v else nv

        def dg(n):
            return max(round(n * dm), 1)

        c = {k: mdiv(k * wm) for k in (64, 128, 256, 512, 1024)}
        layers = [
            FConv(3, c[64], 6, 2, 2),            # 0
            FConv(c[64], c[128], 3, 2),          # 1
            FC3(c[128], c[128], dg(3)),          # 2
            FConv(c[128], c[256], 3, 2),         # 3
            FC3(c[256], c[256], dg(6)),          # 4
            FConv(c[256], c[512], 3, 2),         # 5
            FC3(c[512], c[512], dg(9)),          # 6
            FConv(c[512], c[1024], 3, 2),        # 7
            FC3(c[1024], c[1024], dg(3)),        # 8
            FSPPF(c[1024], c[1024], 5),          # 9
            FConv(c[1024], c[512], 1, 1),        # 10
            nn.Upsample(scale_factor=2.0, mode="nearest"),  # 11
            FConcat(),                           # 12
            FC3(c[1024], c[512], dg(3), False),  # 13
            FConv(c[512], c[256], 1, 1),         # 14
            nn.Upsample(scale_factor=2.0, mode="nearest"),  # 15
            FConcat(),                           # 16
            FC3(c[512], c[256], dg(3), False),   # 17
            FConv(c[256], c[256], 3, 2),         # 18
            FConcat(),                           # 19
            FC3(c[512], c[512], dg(3), False),   # 20
            FConv(c[512], c[512], 3, 2),         # 21
            FConcat(),                           # 22
            FC3(c[1024], c[1024], dg(3), False), # 23
            FDetect(nc, anchors, (c[256], c[512], c[1024])),  # 24
        ]
        self.model = nn.Sequential(*layers)
        self.model[-1].stride = torch.tensor([8.0, 16.0, 32.0])
        # ultralytics stores Detect.anchors normalized by stride after build
        with torch.no_grad():
            self.model[-1].anchors /= self.model[-1].stride.view(-1, 1, 1)
        self.stride = self.model[-1].stride
        # real ultralytics checkpoints carry the FULL parsed yaml incl.
        # backbone/head rows — mirror that so the generic yaml-DSL ingestion
        # path is exercised by the standard fixture too
        self.yaml = {
            "nc": nc, "depth_multiple": dm, "width_multiple": wm, "anchors": anchors,
            "backbone": [
                [-1, 1, "Conv", [64, 6, 2, 2]],
                [-1, 1, "Conv", [128, 3, 2]],
                [-1, 3, "C3", [128]],
                [-1, 1, "Conv", [256, 3, 2]],
                [-1, 6, "C3", [256]],
                [-1, 1, "Conv", [512, 3, 2]],
                [-1, 9, "C3", [512]],
                [-1, 1, "Conv", [1024, 3, 2]],
                [-1, 3, "C3", [1024]],
                [-1, 1, "SPPF", [1024, 5]],
            ],
            "head": [
                [-1, 1, "Conv", [512, 1, 1]],
                [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
                [[-1, 6], 1, "Concat", [1]],
                [-1, 3, "C3", [512, False]],
                [-1, 1, "Conv", [256, 1, 1]],
                [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
                [[-1, 4], 1, "Concat", [1]],
                [-1, 3, "C3", [256, False]],
                [-1, 1, "Conv", [256, 3, 2]],
                [[-1, 14], 1, "Concat", [1]],
                [-1, 3, "C3", [512, False]],
                [-1, 1, "Conv", [512, 3, 2]],
                [[-1, 10], 1, "Concat", [1]],
                [-1, 3, "C3", [1024, False]],
                [[17, 20, 23], 1, "Detect", ["nc", "anchors"]],
            ],
        }

    def forward(self, x):
        m = self.model
        x1 = m[2](m[1](m[0](x)))
        p3 = m[4](m[3](x1))
        p4 = m[6](m[5](p3))
        p5 = m[9](m[8](m[7](p4)))
        i10 = m[10](p5)
        x13 = m[13](m[12]([m[11](i10), p4]))
        i14 = m[14](x13)
        x17 = m[17](m[16]([m[15](i14), p3]))  # P3 out
        x20 = m[20](m[19]([m[18](x17), i14]))  # P4 out
        x23 = m[23](m[22]([m[21](x20), i10]))  # P5 out
        return m[24]([x17, x20, x23])


def randomize_bn_stats(model: nn.Module, seed: int = 0):
    """Give BN layers non-trivial running stats so conv+BN folding is
    actually exercised."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, nn.BatchNorm2d):
            mod.running_mean.copy_(torch.randn(mod.num_features, generator=g) * 0.1)
            mod.running_var.copy_(torch.rand(mod.num_features, generator=g) * 1.5 + 0.3)
            with torch.no_grad():
                mod.weight.copy_(torch.rand(mod.num_features, generator=g) + 0.5)
                mod.bias.copy_(torch.randn(mod.num_features, generator=g) * 0.1)
    return model


class FModelP6(nn.Module):
    """Flat-Sequential DetectionModel lookalike (P6, r6.0 hub layout —
    yolov5s6.yaml: backbone 0-11 ending in SPPF, head 12-32, Detect @33)."""

    def __init__(self, nc=7, dm=0.33, wm=0.25, anchors=None):
        super().__init__()
        if anchors is None:
            anchors = [
                [19, 27, 44, 40, 38, 94],
                [96, 68, 86, 152, 180, 137],
                [140, 301, 303, 264, 238, 542],
                [436, 615, 739, 380, 925, 792],
            ]

        def mdiv(v, d=8):
            nv = max(d, int(v + d / 2) // d * d)
            return nv + d if nv < 0.9 * v else nv

        def dg(n):
            return max(round(n * dm), 1)

        c = {k: mdiv(k * wm) for k in (64, 128, 256, 512, 768, 1024)}
        layers = [
            FConv(3, c[64], 6, 2, 2),             # 0
            FConv(c[64], c[128], 3, 2),           # 1
            FC3(c[128], c[128], dg(3)),           # 2
            FConv(c[128], c[256], 3, 2),          # 3
            FC3(c[256], c[256], dg(6)),           # 4
            FConv(c[256], c[512], 3, 2),          # 5
            FC3(c[512], c[512], dg(9)),           # 6
            FConv(c[512], c[768], 3, 2),          # 7
            FC3(c[768], c[768], dg(3)),           # 8
            FConv(c[768], c[1024], 3, 2),         # 9
            FC3(c[1024], c[1024], dg(3)),         # 10
            FSPPF(c[1024], c[1024], 5),           # 11
            FConv(c[1024], c[768], 1, 1),         # 12
            nn.Upsample(scale_factor=2.0, mode="nearest"),  # 13
            FConcat(),                            # 14
            FC3(c[768] * 2, c[768], dg(3), False),    # 15
            FConv(c[768], c[512], 1, 1),          # 16
            nn.Upsample(scale_factor=2.0, mode="nearest"),  # 17
            FConcat(),                            # 18
            FC3(c[512] * 2, c[512], dg(3), False),    # 19
            FConv(c[512], c[256], 1, 1),          # 20
            nn.Upsample(scale_factor=2.0, mode="nearest"),  # 21
            FConcat(),                            # 22
            FC3(c[256] * 2, c[256], dg(3), False),    # 23
            FConv(c[256], c[256], 3, 2),          # 24
            FConcat(),                            # 25
            FC3(c[256] * 2, c[512], dg(3), False),    # 26
            FConv(c[512], c[512], 3, 2),          # 27
            FConcat(),                            # 28
            FC3(c[512] * 2, c[768], dg(3), False),    # 29
            FConv(c[768], c[768], 3, 2),          # 30
            FConcat(),                            # 31
            FC3(c[768] * 2, c[1024], dg(3), False),   # 32
            FDetect(nc, anchors, (c[256], c[512], c[768], c[1024])),  # 33
        ]
        self.model = nn.Sequential(*layers)
        self.model[-1].stride = torch.tensor([8.0, 16.0, 32.0, 64.0])
        with torch.no_grad():
            self.model[-1].anchors /= self.model[-1].stride.view(-1, 1, 1)
        self.stride = self.model[-1].stride
        self.yaml = {"nc": nc, "depth_multiple": dm, "width_multiple": wm, "anchors": anchors}

    def forward(self, x):
        m = self.model
        x2 = m[2](m[1](m[0](x)))
        p3 = m[4](m[3](x2))
        p4 = m[6](m[5](p3))
        p5 = m[8](m[7](p4))
        p6 = m[11](m[10](m[9](p5)))
        i12 = m[12](p6)
        x15 = m[15](m[14]([m[13](i12), p5]))
        i16 = m[16](x15)
        x19 = m[19](m[18]([m[17](i16), p4]))
        i20 = m[20](x19)
        x23 = m[23](m[22]([m[21](i20), p3]))
        x26 = m[26](m[25]([m[24](x23), i20]))
        x29 = m[29](m[28]([m[27](x26), i16]))
        x32 = m[32](m[31]([m[30](x29), i12]))
        return m[33]([x23, x26, x29, x32])


# --- the benchmark's own additions (not part of the frozen copy) --------

_SPOOF = {
    FConv: ("models.common", "Conv"),
    FBottleneck: ("models.common", "Bottleneck"),
    FC3: ("models.common", "C3"),
    FSPPF: ("models.common", "SPPF"),
    FConcat: ("models.common", "Concat"),
    FDetect: ("models.yolo", "Detect"),
    FModel: ("models.yolo", "DetectionModel"),
    FModelP6: ("models.yolo", "Model"),
}


def save_checkpoint(model: nn.Module, path: str, extra=None) -> None:
    """Write ``model`` as an ultralytics checkpoint (``{'model': ...,
    'epoch': -1}``, its classes pickled under the ultralytics module
    paths), in float16 as ultralytics ships them.  ``extra``: further
    ``class -> ("models.<module>", name)`` pairs, for this call only (a
    reference network's classes of its own).  ``model`` itself is left as it is."""
    import copy

    spoof = {**_SPOOF, **(extra or {})}
    saved = {cls: (cls.__module__, cls.__qualname__, cls.__name__) for cls in spoof}
    mods = {}
    for cls, (mod, name) in spoof.items():
        cls.__module__, cls.__qualname__, cls.__name__ = mod, name, name
        setattr(mods.setdefault(mod, types.ModuleType(mod)), name, cls)
    pkg = types.ModuleType("models")
    for name, m in mods.items():
        setattr(pkg, name.split(".")[1], m)
    mods["models"] = pkg
    sys.modules.update(mods)
    try:
        torch.save({"model": copy.deepcopy(model).half(), "epoch": -1}, path)
    finally:
        for name in mods:
            sys.modules.pop(name, None)
        for cls, (mod, qual, name) in saved.items():
            cls.__module__, cls.__qualname__, cls.__name__ = mod, qual, name


def build(p6: bool, nc: int, dm: float, wm: float, anchors) -> nn.Module:
    """The reference network of a configuration, in evaluation mode."""
    cls = FModelP6 if p6 else FModel
    return cls(nc=nc, dm=dm, wm=wm, anchors=[list(a) for a in anchors]).eval()


class _RawHead(nn.Module):
    """Stands in for ``Detect`` while ``head_logits`` runs: the per-level
    convolutions alone, no decode."""

    def __init__(self, det):
        super().__init__()
        self.det = det

    def forward(self, feats):
        return [conv(x) for conv, x in zip(self.det.m, feats)]


def head_logits(model: nn.Module, x: torch.Tensor):
    """Raw per-level head logits of NCHW images ``x``: a list of (B, A,
    H_l, W_l, 5 + nc) tensors, from the frozen ``forward`` with the
    ``Detect`` convolutions in place of the whole ``Detect`` (whose decode
    builds its grid on the CPU)."""
    det = model.model[-1]
    model.model[-1] = _RawHead(det)
    try:
        raw = model(x)
    finally:
        model.model[-1] = det
    out = []
    for r in raw:
        bs, _, ny, nx = r.shape
        out.append(r.view(bs, det.na, det.no, ny, nx).permute(0, 1, 3, 4, 2))
    return out
