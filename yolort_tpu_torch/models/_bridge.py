"""Load a JAX ``Params`` tree (every leaf a numpy array) into the port.

The port's modules carry the JAX params keys as child names, so the tree
is walked key by key; each conv leaf goes to its module's ``set_params``,
which turns HWIO weights into OIHW and takes any Conv form (fused
{'w','b'}, unfused BatchNorm, or int8 compute {'wq','ws','xs'[,'os','b']}).
A BatchNorm leaf {'gamma','beta','mean','var'} and a Linear leaf {'w'
(in, out)[,'b']} go to theirs.  A bare array under a module is its
parameter of that name: the attention's flattened ``in_proj_w`` and
``in_proj_b`` of a TransformerLayer.  A Bottleneck's ``'as'`` (its
calibrated post-add scale) becomes ``as_``.  Scales arrive as floats or
0-d arrays (a finalized JAX tree's ``StaticScale``s unwrapped to their
values).
"""

from __future__ import annotations

from typing import Mapping

from torch import nn

from yolort_tpu_torch.ops.blocks import (
    BatchNorm, Bottleneck, Conv, Conv2dOnly, Linear, _as_tensor,
)


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
    if isinstance(model, (BatchNorm, Linear)):
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
