"""Experimental blocks: CrossConv, Sum, MixConv2d.

Port of ``yolort_tpu/ops/experimental.py``.  Child and parameter names are
the JAX params keys (``cv1``, ``w``, ``"0"``, ...), so ``models/_bridge.py``
loads a JAX tree into them.  Model ensembling is ``models/ensemble.py``.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolort_tpu_torch.ops.blocks import Conv, _as_float, _as_tensor, _param, _qconcat, _uniform


class _RectConv(nn.Module):
    """Conv with a rectangular ``k`` = (kh, kw) kernel, stride ``s`` =
    (sh, sw), padding (kh//2, kw//2), a bias and SiLU; the JAX leaf {'w'
    HWIO, 'b'}."""

    def __init__(self, c1: int, c2: int, k: Tuple[int, int], s: Tuple[int, int], g: int = 1, *,
                 gen: torch.Generator):
        super().__init__()
        kh, kw = k
        self.s, self.pad, self.g = tuple(s), (kh // 2, kw // 2), g
        self.weight = nn.Parameter(_uniform(gen, (c2, c1 // g, kh, kw),
                                            1.0 / math.sqrt(kh * kw * (c1 // g))))
        self.bias = nn.Parameter(torch.zeros(c2))

    def set_params(self, p: Dict[str, np.ndarray]) -> None:
        self.weight.data = _as_tensor(np.asarray(p["w"]).transpose(3, 2, 0, 1), self.weight)
        self.bias.data = _as_tensor(p["b"], self.bias)

    def init_train(self, gen: torch.Generator) -> None:
        """JAX's init: weight U(-b, b), b = 1/sqrt(fan_in), zero bias."""
        w = self.weight
        self.weight = _param(_uniform(gen, w.shape, 1.0 / math.sqrt(w[0].numel())), w)
        self.bias = _param(torch.zeros(w.shape[0]), w)

    def forward(self, x):
        return F.silu(F.conv2d(_as_float(x), self.weight, self.bias, self.s, self.pad, 1, self.g))


class CrossConv(nn.Module):
    """Cross convolution: a 1xk conv then a kx1 conv (stride ``s`` on each
    axis in turn), with a residual when ``shortcut`` and c1 == c2."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, g: int = 1, e: float = 1.0,
                 shortcut: bool = False, *, gen: torch.Generator):
        super().__init__()
        c_ = int(c2 * e)
        self.s = s
        self.cv1 = _RectConv(c1, c_, (1, k), (1, s), gen=gen)
        self.cv2 = _RectConv(c_, c2, (k, 1), (s, 1), g=g, gen=gen)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return _as_float(x) + y if self.add else y


class Sum(nn.Module):
    """Sum of ``n`` inputs; with ``weight`` the inputs after the first are
    scaled by 2 * sigmoid(w), w initialised to -arange(1, n) / 2."""

    def __init__(self, n: int, weight: bool = False):
        super().__init__()
        self.n = n
        if weight:
            self.w = nn.Parameter(-torch.arange(1.0, n) / 2.0)
        else:
            self.w = None

    def init_train(self, gen: torch.Generator) -> None:
        """JAX's init (draws nothing from ``gen``)."""
        if self.w is not None:
            self.w = _param(-torch.arange(1.0, self.n) / 2.0, self.w)

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        y = xs[0]
        w = None if self.w is None else torch.sigmoid(self.w) * 2.0
        for i in range(self.n - 1):
            y = y + (xs[i + 1] if w is None else xs[i + 1] * w[i])
        return y


class MixConv2d(nn.Module):
    """Convs of several kernel sizes ``k`` side by side, the output
    channels split equally with the remainder on the first; children
    "0".."len(k)-1"."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (1, 3), s: int = 1, *,
                 gen: torch.Generator):
        super().__init__()
        n = len(k)
        splits = [c2 // n] * n
        splits[0] += c2 - sum(splits)
        self.s = s
        for i, (c_out, kk) in enumerate(zip(splits, k)):
            self.add_module(str(i), Conv(c1, c_out, kk, s, act="silu", gen=gen))

    def forward(self, x):
        return _qconcat([m(x) for m in self.children()])


# the blocks ``blocks.init_train`` redraws beside its own
TRAIN_BLOCKS = (_RectConv, Sum)
