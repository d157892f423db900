"""Post-training quantization for int8 compute.

Port of the int8-compute recipe of ``yolort_tpu/ops/quantization.py``:
``quantize_tensor_per_channel``, ``calibrate_activations``,
``quantize_compute_params``, ``finalize_scales`` and ``strip_calibration``.
The JAX functions take ``(apply_fn, params)``; these take the model (an
``nn.Module`` whose ``head_outputs`` is the apply function) and keep the
JAX names.  The recipe, as the bench runs it:

    calibrate_activations(model, batches)        # marks ranges in place
    qmodel = quantize_compute_params(model)      # a quantized copy
    finalize_scales(qmodel, example)             # fixes and unifies scales

after which ``YOLOv5(model=qmodel, ...)`` serves it in float32 or bfloat16.
"""

from __future__ import annotations

import copy
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from yolort_tpu_torch.ops import blocks
from yolort_tpu_torch.ops.blocks import Bottleneck, Conv, Conv2dOnly, fuse_conv_bn

_MARKS = ("_absmax", "_out_absmax", "_add_absmax")
# convs with a shallower reduction (kh*kw*cin) stay float: int8 buys
# little there and costs the most accuracy (the JAX recipe's default)
MIN_REDUCE = 32


class ScaleLeaf(float):
    """A calibrated activation scale before ``finalize_scales``: a float
    whose object identity names the leaf it came from, as a scale array
    does in the JAX tree.  ``finalize_scales`` matches concat parts to
    leaves by identity and replaces every leaf with a plain float."""

    __slots__ = ()


def quantize_tensor_per_channel(w: np.ndarray, axis: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization with per-channel scales along ``axis``."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != (axis % w.ndim))
    amax = np.abs(w).max(axis=reduce_axes, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, np.squeeze(scale)


def _observe(module: nn.Module, key: str, t: torch.Tensor) -> None:
    amax = float(t.detach().float().abs().amax())
    setattr(module, key, max(getattr(module, key, 0.0), amax))


def _conv_hook(module, inputs, output):
    _observe(module, "_absmax", inputs[0])
    if isinstance(module, Conv):
        _observe(module, "_out_absmax", output)


def _add_hook(module, inputs, output):
    if module.add:
        _observe(module, "_add_absmax", output)


def _float_dtype(model: nn.Module) -> torch.dtype:
    return next((t.dtype for t in (*model.parameters(), *model.buffers())
                 if t.is_floating_point()), torch.float32)


def calibrate_activations(model: nn.Module, batches: Iterable) -> nn.Module:
    """Run ``model.head_outputs`` eagerly over calibration batches (B, H, W,
    3) while every float Conv / Conv2dOnly records the abs-max of its input
    (``_absmax``), every Conv that of its output (``_out_absmax``) and every
    residual Bottleneck that of its sum (``_add_absmax``), as attributes,
    maximised over batches.  Runs in float32 with TF32 off (on a float32
    copy when the model is in another dtype; the ranges are copied back).
    Returns ``model``, marked in place."""
    cal = model if _float_dtype(model) == torch.float32 else copy.deepcopy(model).float()
    device = next(iter(cal.parameters())).device
    hooks = []
    for mod in cal.modules():
        if isinstance(mod, (Conv, Conv2dOnly)) and not mod.quantized:
            hooks.append(mod.register_forward_hook(_conv_hook))
        elif isinstance(mod, Bottleneck):
            hooks.append(mod.register_forward_hook(_add_hook))
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.inference_mode():
            for batch in batches:
                b = torch.as_tensor(batch, device=device)
                cal.head_outputs(b.float() if b.is_floating_point() else b)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
        for h in hooks:
            h.remove()
    if cal is not model:
        src = dict(cal.named_modules())
        for name, mod in model.named_modules():
            for key in _MARKS:
                if hasattr(src[name], key):
                    setattr(mod, key, getattr(src[name], key))
    return model


def _hwio(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().transpose(2, 3, 1, 0)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _pop_marks(mod: nn.Module) -> Dict[str, float]:
    return {k: mod.__dict__.pop(k) for k in _MARKS if k in mod.__dict__}


def _refuse_int8_gaps(model: nn.Module) -> None:
    for name, mod in model.named_modules():
        if not isinstance(mod, (Conv, Conv2dOnly)):
            continue
        if mod.g != 1 or getattr(mod, "act", None) == "relu":
            raise ValueError(
                f"int8 of grouped and ReLU convs is not ported: conv '{name}' has groups={mod.g}, "
                f"act={getattr(mod, 'act', 'none')!r} (the qconv kernels take groups=1 and no "
                f"ReLU epilogue); serve this model in float32 or bfloat16")


def quantize_compute_params(model: nn.Module) -> nn.Module:
    """A copy of a calibrated model in the int8-compute form: every conv
    with a recorded input range and a reduction depth kh*kw*cin >=
    ``MIN_REDUCE`` gets int8 weights (per output channel), its input scale
    ``xs`` and, with a recorded output range, the output scale ``os`` its
    epilogue requantizes to; unfused BatchNorm is folded first.  Each
    residual Bottleneck with a recorded sum range gets ``as_``.  Markers are
    dropped from the copy either way; ``model`` is left as it is.

    A model that holds a grouped conv or a ReLU conv (yolo_lite, the Ghost
    blocks, DWConv) raises ``ValueError``: the qconv kernels run groups=1
    and their epilogue has no ReLU, where the JAX package sends such convs
    to XLA's int8 conv."""
    _refuse_int8_gaps(model)
    out = copy.deepcopy(model)
    for mod in out.modules():
        marks = _pop_marks(mod)
        if isinstance(mod, Bottleneck):
            add = marks.get("_add_absmax")
            if add is not None and add > 0.0:
                mod.as_ = ScaleLeaf(np.float32(add / 127.0))
            continue
        if not isinstance(mod, (Conv, Conv2dOnly)) or mod.quantized:
            continue
        amax, out_amax = marks.get("_absmax"), marks.get("_out_absmax")
        w = _hwio(mod.weight)
        kh, kw, cin_g, _ = w.shape
        if amax is None or amax <= 0.0 or kh * kw * cin_g < MIN_REDUCE:
            continue
        if "gamma" in mod._parameters:
            w, b = fuse_conv_bn(w, _np(mod.gamma), _np(mod.beta), _np(mod.mean), _np(mod.var))
        else:
            b = None if mod.bias is None else _np(mod.bias)
        wq, ws = quantize_tensor_per_channel(w, axis=-1)
        os: Optional[float] = None
        if out_amax is not None and out_amax > 0.0:
            os = ScaleLeaf(np.float32(out_amax / 127.0))
        mod.set_int8(wq, np.atleast_1d(ws), ScaleLeaf(np.float32(amax / 127.0)), os, b)
    return out


def _scale_slots(model: nn.Module):
    """(module, attribute) of every activation scale of a quantized model."""
    for mod in model.modules():
        if isinstance(mod, (Conv, Conv2dOnly)) and mod.quantized:
            yield mod, "xs"
            yield mod, "os"
        elif isinstance(mod, Bottleneck):
            yield mod, "as_"


def finalize_scales(model: nn.Module, example) -> nn.Module:
    """Fix a quantized model's activation scales as plain floats and unify
    every concat group's output scales to the group's max.

    One eager pass of ``model.head_outputs(example)`` (a small example is
    enough: the routing of scales does not depend on the shape) records,
    per concat, which scale leaves its parts carry.  Union-find merges the
    groups (a tensor that two concats read, such as a backbone tap of the
    PAN, joins them), and every ``xs`` / ``os`` / ``as_`` in a group takes the
    group's max; every other scale keeps its value.  Afterwards each concat
    is a plain int8 concatenation with no rescale.  Returns ``model``,
    changed in place."""
    device = next(iter(model.buffers())).device
    x = torch.as_tensor(example, device=device).to(_float_dtype(model))
    groups: list = []
    blocks._UNIFY = groups
    try:
        with torch.inference_mode():
            model.head_outputs(x)
    finally:
        blocks._UNIFY = None

    parent: Dict[int, int] = {}
    val: Dict[int, float] = {}

    def find(i: int) -> int:
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    for grp in groups:
        ids = []
        for s in grp:
            i = id(s)
            if i not in parent:
                parent[i], val[i] = i, float(s)
            ids.append(i)
        r0 = find(ids[0])
        for i in ids[1:]:
            r = find(i)
            if r != r0:
                parent[r] = r0
    group_max: Dict[int, float] = {}
    for i in parent:
        r = find(i)
        group_max[r] = max(group_max.get(r, 0.0), val[i])

    for mod, attr in _scale_slots(model):
        v = getattr(mod, attr)
        if v is not None:
            setattr(mod, attr, group_max[find(id(v))] if id(v) in parent else float(v))
    return model


def strip_calibration(model: nn.Module) -> nn.Module:
    """Drop the calibration markers without quantizing; returns ``model``."""
    for mod in model.modules():
        _pop_marks(mod)
    return model
