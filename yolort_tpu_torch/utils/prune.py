"""Magnitude pruning.

Port of ``yolort_tpu/utils/prune.py`` (the reference's prune / sparsity
helpers) on modules: ``prune`` zeroes the smallest weights of every conv
and Linear of a copy, ``sparsity`` counts zeros over the model's JAX
params tree (``models/_bridge.params_to_jax``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import nn

from yolort_tpu_torch.models._bridge import params_to_jax
from yolort_tpu_torch.ops.blocks import Conv, Conv2dOnly, Linear
from yolort_tpu_torch.ops.experimental import _RectConv


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def sparsity(model: nn.Module) -> float:
    """The fraction of exactly-zero values over every leaf of the float
    model's params tree."""
    leaves = list(_leaves(params_to_jax(model)))
    total = sum(a.size for a in leaves)
    return sum(int((a == 0).sum()) for a in leaves) / max(total, 1)


def prune(model: nn.Module, amount: float = 0.3) -> nn.Module:
    """A copy of ``model`` in which the entries of every float conv and
    Linear weight (the params tree's 'w' leaves of two or more dimensions)
    at or below that weight's ``np.quantile(|w|, amount)`` are zero; biases
    and BatchNorm statistics are kept, and ``model`` is left as it is."""
    out = copy.deepcopy(model)
    with torch.no_grad():
        for m in out.modules():
            w = getattr(m, "weight", None) if isinstance(m, (Conv, Conv2dOnly, Linear,
                                                               _RectConv)) else None
            if w is None or w.ndim < 2:
                continue
            arr = w.float().cpu().numpy()
            thresh = np.quantile(np.abs(arr), amount)
            w.copy_(torch.from_numpy(np.where(np.abs(arr) <= thresh, 0, arr)))
    return out
