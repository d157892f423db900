"""Small shared utilities.

Port of ``yolort_tpu/utils/common.py``: ``cast_floating`` casts the
floating-point leaves of a model (its parameters and buffers, in place:
``Module.to(dtype)``) or of a nested dict / list / tuple of tensors and
numpy arrays; integer leaves stay as they are.  ``count_params`` counts
the elements of a model's parameters or of such a tree's leaves.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch import nn


def cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """The floating-point leaves of ``tree`` in ``dtype`` (the bf16 analog of
    the reference's ``.half()`` deployment cast).  A module is cast in place
    and returned; a tree is rebuilt, a numpy leaf becoming a tensor."""
    if isinstance(tree, nn.Module):
        return tree.to(dtype)
    if isinstance(tree, dict):
        return {k: cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floating(v, dtype) for v in tree)
    t = torch.from_numpy(np.asarray(tree)) if isinstance(tree, np.ndarray) else tree
    if isinstance(t, torch.Tensor) and t.is_floating_point():
        return t.to(dtype)
    return t


def count_params(tree: Any) -> int:
    """The number of elements of a model's parameters, or of a tree's leaves."""
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return int(np.prod(tuple(tree.shape)))
