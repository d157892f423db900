"""Load a JAX ``Params`` tree (every leaf a numpy array) into the port.

The port's modules carry the JAX params keys as child names, so the tree
is walked key by key; each conv leaf goes to its module's ``set_params``,
which turns HWIO weights into OIHW and takes either Conv form (fused
{'w','b'} or unfused BatchNorm).
"""

from __future__ import annotations

from typing import Mapping

from torch import nn

from yolort_tpu_torch.ops.blocks import Conv, Conv2dOnly


def params_from_jax(params_np: Mapping, model: nn.Module) -> nn.Module:
    """Copy ``params_np`` into ``model`` (a YOLO or any block) in place."""
    if isinstance(model, (Conv, Conv2dOnly)):
        model.set_params(params_np)
        return model
    for key, sub in params_np.items():
        child = model._modules.get(key)
        if child is None:
            raise KeyError(f"{type(model).__name__} has no child '{key}'")
        params_from_jax(sub, child)
    return model
