"""Load a JAX ``Params`` tree (every leaf a numpy array) into the port.

The port's modules carry the JAX params keys as child names, so the tree
is walked key by key; each conv leaf goes to its module's ``set_params``,
which turns HWIO weights into OIHW and takes any Conv form (fused
{'w','b'}, unfused BatchNorm, or int8 compute {'wq','ws','xs'[,'os','b']}).
A BatchNorm leaf {'gamma','beta','mean','var'}, a Linear leaf {'w'
(in, out)[,'b']} and a rectangular conv's {'w','b'} go to theirs.  A bare array under a module is its
parameter of that name: the attention's flattened ``in_proj_w`` and
``in_proj_b`` of a TransformerLayer.  A Bottleneck's ``'as'`` (its
calibrated post-add scale) becomes ``as_``.  Scales arrive as floats or
0-d arrays (a finalized JAX tree's ``StaticScale``s unwrapped to their
values).

``params_to_jax`` is the inverse for a float model: the module's
parameters as that numpy tree, or (``leaf``) any tensor kept per
parameter under the same keys, such as its gradient or momentum buffer.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import numpy as np
import torch
from torch import nn

from yolort_tpu_torch.ops.blocks import (
    BN_NAMES, BatchNorm, Bottleneck, Conv, Conv2dOnly, Linear, _as_tensor,
)
from yolort_tpu_torch.ops.experimental import _RectConv


def params_from_jax(params_np: Mapping, model: nn.Module) -> nn.Module:
    """Copy ``params_np`` into ``model`` (a YOLO or any block) in place."""
    if isinstance(model, (Conv, Conv2dOnly)):
        p = params_np
        if "wq" in p:
            os = p.get("os")
            model.set_int8(p["wq"], p["ws"], float(p["xs"]), None if os is None else float(os),
                           p.get("b"))
        else:
            model.set_params(p)
        return model
    if isinstance(model, (BatchNorm, Linear, _RectConv)):
        model.set_params(params_np)
        return model
    for key, sub in params_np.items():
        if key == "as" and isinstance(model, Bottleneck):
            model.as_ = float(sub)
            continue
        if not isinstance(sub, Mapping):
            param = model._parameters.get(key)
            if param is None:
                raise KeyError(f"{type(model).__name__} has no parameter '{key}'")
            param.data = _as_tensor(sub, param)
            continue
        child = model._modules.get(key)
        if child is None:
            raise KeyError(f"{type(model).__name__} has no child '{key}'")
        params_from_jax(sub, child)
    return model


def params_to_jax(model: nn.Module,
                  leaf: Optional[Callable[[nn.Parameter], torch.Tensor]] = None) -> dict:
    """``model``'s float parameters as the JAX params tree of numpy f32
    arrays: conv weights HWIO, Linear weights (in, out), fused {'w','b'}
    or unfused {'w','gamma','beta','mean','var'} as each conv holds them.
    ``leaf(param)`` picks the tensor written for each parameter (default:
    the parameter itself)."""
    pick = leaf or (lambda p: p)

    def arr(p, layout=None):
        t = pick(p).detach()
        t = t if layout is None else layout(t)
        return np.array(t.float().cpu().numpy(), order="C")  # a copy: never the tensor's memory

    if isinstance(model, (Conv, Conv2dOnly, _RectConv)):
        if getattr(model, "quantized", False):
            raise ValueError("params_to_jax takes float models; this conv is int8")
        out = {"w": arr(model.weight, lambda t: t.permute(2, 3, 1, 0))}
        if model.bias is not None:
            out["b"] = arr(model.bias)
        out.update({k: arr(model._parameters[k]) for k in BN_NAMES if k in model._parameters})
        return out
    if isinstance(model, Linear):
        out = {"w": arr(model.weight, lambda t: t.T)}
        if model.bias is not None:
            out["b"] = arr(model.bias)
        return out
    if isinstance(model, BatchNorm):
        return {k: arr(model._parameters[k]) for k in BN_NAMES}
    out = {k: arr(p) for k, p in model._parameters.items() if p is not None}
    for key, child in model._modules.items():
        sub = params_to_jax(child, leaf)
        if sub:
            out[key] = sub
    return out
