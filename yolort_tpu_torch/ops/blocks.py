"""YOLOv5 building blocks as ``nn.Module``s, float path.

Port of ``yolort_tpu/ops/blocks.py`` (Conv, Conv2dOnly, Bottleneck, C3,
SPP/SPPF, ``max_pool_same``, ``upsample2x``).  Activations are NCHW in
``channels_last`` memory; weights are OIHW.  Child names mirror the JAX
params tree (``cv1``, ``m.0``, ...), so ``models/_bridge.py`` loads a JAX
tree by walking it.

Initialisation draws from a ``torch.Generator`` on the CPU, so one seed
gives the same weights on every device; the model is moved to its device
once built.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# BatchNorm epsilon of the model zoo (as in the JAX package)
BN_EPS = 1e-3


def autopad(k: int, p: Optional[int] = None) -> int:
    """'same' padding rule."""
    return k // 2 if p is None else p


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * bound


def _as_tensor(a, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=like.device).to(like.dtype)


class Conv2dOnly(nn.Module):
    """Bare conv with optional bias (the detection-head 1x1 convs)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, bias: bool = True, *, gen: torch.Generator):
        super().__init__()
        self.s, self.pad, self.g = s, autopad(k, p), g
        bound = 1.0 / math.sqrt(k * k * (c1 // g))  # torch's Conv2d default init
        self.weight = nn.Parameter(_uniform(gen, (c2, c1 // g, k, k), bound))
        self.bias = nn.Parameter(_uniform(gen, (c2,), bound)) if bias else None

    def set_params(self, p: Dict[str, np.ndarray]) -> None:
        """Load a JAX leaf {'w' HWIO[, 'b']}."""
        self.weight.data = _as_tensor(np.asarray(p["w"]).transpose(3, 2, 0, 1), self.weight)
        self.bias = nn.Parameter(_as_tensor(p["b"], self.weight)) if "b" in p else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, self.s, self.pad, 1, self.g)


class Conv(nn.Module):
    """Conv2d + BatchNorm + SiLU.

    Two parameter forms, as in JAX: fused (``weight`` + ``bias``; random
    init folds the identity BatchNorm of a fresh model into the weight) or
    unfused (``weight`` + the BatchNorm buffers ``gamma``, ``beta``,
    ``mean``, ``var``, applied after the conv as ``y * scale + bias``)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, *, gen: torch.Generator):
        super().__init__()
        self.s, self.pad, self.g = s, autopad(k, p), g
        bound = 1.0 / math.sqrt(k * k * (c1 // g))
        w = _uniform(gen, (c2, c1 // g, k, k), bound) * (1.0 / math.sqrt(1.0 + BN_EPS))
        self.weight = nn.Parameter(w)
        self.bias: Optional[nn.Parameter] = nn.Parameter(torch.zeros(c2))

    def set_params(self, p: Dict[str, np.ndarray]) -> None:
        """Load a JAX leaf, fused {'w','b'} or unfused {'w','gamma','beta','mean','var'}."""
        self.weight.data = _as_tensor(np.asarray(p["w"]).transpose(3, 2, 0, 1), self.weight)
        if "b" in p:
            self.bias = nn.Parameter(_as_tensor(p["b"], self.weight))
            for name in ("gamma", "beta", "mean", "var"):
                self._buffers.pop(name, None)
        else:
            self.bias = None
            for name in ("gamma", "beta", "mean", "var"):
                self.register_buffer(name, _as_tensor(p[name], self.weight))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.bias is not None:
            return silu(F.conv2d(x, self.weight, self.bias, self.s, self.pad, 1, self.g))
        y = F.conv2d(x, self.weight, None, self.s, self.pad, 1, self.g)
        # scale and shift in f32, cast to the activation type (as in JAX)
        scale = self.gamma.float() * torch.rsqrt(self.var.float() + BN_EPS)
        bias = self.beta.float() - self.mean.float() * scale
        y = y * scale.to(y.dtype)[:, None, None] + bias.to(y.dtype)[:, None, None]
        return silu(y)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (+ residual when shapes allow)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 *, gen: torch.Generator):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, gen=gen)
        self.cv2 = Conv(c_, c2, 3, 1, g=g, gen=gen)
        self.add = shortcut and c1 == c2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, *, gen: torch.Generator):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, gen=gen)
        self.cv2 = Conv(c1, c_, 1, 1, gen=gen)
        self.cv3 = Conv(2 * c_, c2, 1, gen=gen)
        self.m = nn.ModuleList(Bottleneck(c_, c_, shortcut, g, e=1.0, gen=gen) for _ in range(n))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.cv1(x)
        for b in self.m:
            y1 = b(y1)
        return self.cv3(torch.cat([y1, self.cv2(x)], dim=1))


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max pool, stride 1, padded by k//2 with -inf."""
    return F.max_pool2d(x, k, 1, k // 2)


class SPP(nn.Module):
    """Spatial pyramid pooling with k=(5, 9, 13), computed as a chain of
    three 5x5 pools (the SPPF identity); same parameters as SPPF."""

    def __init__(self, c1: int, c2: int, *, gen: torch.Generator):
        super().__init__()
        c_ = c1 // 2
        self.cv1 = Conv(c1, c_, 1, 1, gen=gen)
        self.cv2 = Conv(c_ * 4, c2, 1, 1, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cv1(x)
        y1 = max_pool_same(x, 5)
        y2 = max_pool_same(y1, 5)
        y3 = max_pool_same(y2, 5)
        return self.cv2(torch.cat([x, y1, y2, y3], dim=1))


SPPF = SPP


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample."""
    return F.interpolate(x, scale_factor=2.0, mode="nearest")
