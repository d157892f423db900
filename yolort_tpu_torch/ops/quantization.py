"""Post-training quantization: int8 compute and weight-only int8.

Port of ``yolort_tpu/ops/quantization.py``.  The int8-compute recipe:
``quantize_tensor_per_channel``, ``calibrate_activations``,
``quantize_compute_params`` (with ``skip``, ``min_reduce``, ``predicate``
and ``chain``), ``finalize_scales``, ``strip_calibration``,
``quant_groups`` and ``sensitivity_scan``.  The JAX functions take
``(apply_fn, params)``; these take the model (an ``nn.Module`` whose
``head_outputs`` is the apply function) and keep the JAX names.  A conv's
path is its JAX params path, '/'-joined (``backbone/body/5/expand``): the
port's module names are the JAX keys.  The recipe, as the bench runs it:

    calibrate_activations(model, batches)        # marks ranges in place
    qmodel = quantize_compute_params(model)      # a quantized copy
    finalize_scales(qmodel, example)             # fixes and unifies scales

after which ``YOLOv5(model=qmodel, ...)`` serves it in float32 or bfloat16.
Before ``finalize_scales`` the scales are runtime ``ScaleLeaf``s, on which
``sensitivity_scan`` and ``utils/quant_probe.py`` run, as JAX's do.

Weight-only PTQ (``quantize_params``, ``dequantize_params``,
``dequantize_tensor``, ``quantization_error``) works on the bridge's
nested JAX-layout dict (``models/_bridge.py``), and
``CalibrationObserver`` keeps moving abs-max ranges for export.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from yolort_tpu_torch.ops import blocks
from yolort_tpu_torch.ops.blocks import (
    Bottleneck, Conv, Conv2dOnly, ScaleLeaf, fuse_conv_bn, host_f32,
)

_MARKS = ("_absmax", "_out_absmax", "_add_absmax")
# convs with a shallower reduction (kh*kw*cin/groups) stay float: int8
# buys little there and costs the most accuracy (the JAX recipe's default)
MIN_REDUCE = 32


def quantize_tensor_per_channel(w: np.ndarray, axis: int = -1) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantization with per-channel scales along ``axis``."""
    w = np.asarray(w, np.float32)
    reduce_axes = tuple(i for i in range(w.ndim) if i != (axis % w.ndim))
    amax = np.abs(w).max(axis=reduce_axes, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, np.squeeze(scale)


def dequantize_tensor(q: torch.Tensor, scale: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_tensor_per_channel`` (scale broadcast on the
    last axis), in ``dtype``."""
    return torch.as_tensor(q).to(dtype) * torch.as_tensor(scale).to(dtype)


def quantize_params(params: Dict, min_size: int = 512) -> Dict:
    """Quantize the conv / Linear weights of a JAX-layout params tree
    ('w' leaves of >= ``min_size`` elements) to {'q': int8, 'scale': f32}
    torch tensors, per output channel (the last axis); other leaves pass
    through."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            if k == "w" and not isinstance(v, dict) and np.size(host_f32(v)) >= min_size:
                q, scale = quantize_tensor_per_channel(host_f32(v))
                out["w"] = {"q": torch.from_numpy(q), "scale": torch.from_numpy(scale)}
            else:
                out[k] = walk(v)
        return out

    return walk(params)


def dequantize_params(params: Dict, dtype: torch.dtype = torch.bfloat16) -> Dict:
    """A quantized tree with every {'q', 'scale'} back to dense weights in
    ``dtype`` (``params_from_jax`` loads the result into a model)."""

    def walk(node):
        if not isinstance(node, dict):
            return node
        if set(node) == {"q", "scale"}:
            return dequantize_tensor(node["q"], node["scale"], dtype)
        return {k: walk(v) for k, v in node.items()}

    return walk(params)


def _leaves(node) -> Iterator:
    """The leaves of a tree in the JAX package's order (keys sorted)."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield from _leaves(node[k])
    else:
        yield node


def quantization_error(params: Dict, qparams: Dict) -> Dict[str, float]:
    """Max relative weight error of weight-only PTQ, per top-level group:
    max |w - dequant(q)| / (max |w| + 1e-12) over the group's leaves of
    equal shape, in float32."""
    deq = dequantize_params(qparams, torch.float32)
    out = {}
    for key in params:
        errs = []
        for a, b in zip(_leaves(params[key]), _leaves(deq[key])):
            a, b = host_f32(a), host_f32(b)
            if a.shape == b.shape:
                errs.append(float(np.abs(a - b).max() / (np.abs(a).max() + np.float32(1e-12))))
        out[key] = max(errs) if errs else 0.0
    return out


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


def conv_paths(model: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """(JAX params path, module) of every Conv / Conv2dOnly, in the order of
    the JAX package's calibrated tree: children by name, sorted as strings
    at every level (a ``jax.tree_util`` round trip sorts dict keys)."""

    def walk(mod: nn.Module, path: Tuple[str, ...]):
        if isinstance(mod, (Conv, Conv2dOnly)):
            yield "/".join(path), mod
            return
        for name in sorted(mod._modules):
            child = mod._modules[name]
            if child is not None:
                yield from walk(child, path + (name,))

    yield from walk(model, ())


def quantize_compute_params(
    model: nn.Module,
    skip: Sequence[str] = (),
    min_reduce: int = MIN_REDUCE,
    predicate: Optional[Callable[[str, tuple], bool]] = None,
    chain: bool = True,
) -> nn.Module:
    """A copy of a calibrated model in the int8-compute form.

    A conv is quantized when (a) calibration recorded an input range, (b)
    its reduction depth kh*kw*cin/groups is >= ``min_reduce`` (depth-wise
    convs stay float by default: int8 buys little there and costs the most
    accuracy), (c) its path (``conv_paths``) starts with no entry of
    ``skip`` and (d) ``predicate(path, hwio_shape)``, when given, is true.
    It gets int8 weights (per output channel), its input scale ``xs`` and,
    with ``chain`` and a recorded output range, the output scale ``os`` its
    epilogue requantizes to; unfused BatchNorm is folded first.  With
    ``chain``, each residual Bottleneck with a recorded sum range gets
    ``as_``.  Scales are runtime ``ScaleLeaf``s until ``finalize_scales``.
    Markers are dropped from the copy either way; ``model`` is left as it
    is."""
    out = copy.deepcopy(model)
    for mod in out.modules():
        if isinstance(mod, Bottleneck):
            add = _pop_marks(mod).get("_add_absmax")
            if chain and add is not None and add > 0.0:
                mod.as_ = ScaleLeaf(np.float32(add / 127.0))
    for path, mod in conv_paths(out):
        marks = _pop_marks(mod)
        if mod.quantized:
            continue
        amax, out_amax = marks.get("_absmax"), marks.get("_out_absmax")
        w = _hwio(mod.weight)
        kh, kw, cin_g, _ = w.shape
        if (amax is None or amax <= 0.0 or kh * kw * cin_g < min_reduce
                or any(path.startswith(p) for p in skip)
                or (predicate is not None and not predicate(path, w.shape))):
            continue
        if "gamma" in mod._parameters:
            w, b = fuse_conv_bn(w, _np(mod.gamma), _np(mod.beta), _np(mod.mean), _np(mod.var))
        else:
            b = None if mod.bias is None else _np(mod.bias)
        wq, ws = quantize_tensor_per_channel(w, axis=-1)
        os: Optional[float] = None
        if chain and out_amax is not None and out_amax > 0.0:
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

    One eager pass of the network, ``model._network(example)`` (never a
    CUDA graph's replay, which runs no Python; a small example is
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
            model._network(x)
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


def quant_groups(model: nn.Module, depth: int = 2) -> Tuple[str, ...]:
    """The path prefixes of ``depth`` components holding calibrated convs,
    in the JAX tree's order: the unit ``sensitivity_scan`` quantizes alone
    and ``quantize_compute_params(skip=...)`` leaves out."""
    groups: list = []
    for path, mod in conv_paths(model):
        g = "/".join(path.split("/")[:depth])
        if "_absmax" in mod.__dict__ and g not in groups:
            groups.append(g)
    return tuple(groups)


def _flat(out) -> torch.Tensor:
    if isinstance(out, torch.Tensor):
        return out.reshape(-1).float()
    return torch.cat([_flat(o) for o in out])


def sensitivity_scan(apply_fn, model: nn.Module, batch, depth: int = 2,
                     norm: Optional[float] = None) -> list:
    """Per-group PTQ sensitivity of a calibrated model: for each group of
    ``quant_groups(model, depth)``, quantize only that group and take the
    mean |delta| of ``apply_fn``'s flattened outputs against the float
    model's on ``batch`` (divided by ``norm`` when given).  ``apply_fn(m,
    x)`` returns a tensor or a tuple of them (``lambda m, x: m.decode(x)``).
    Returns [(group, delta)], worst first.  The recipe: quantize
    everything, measure the end metric; where it regresses, skip the
    first groups of this list (``quantize_compute_params(skip=...)``)."""
    with torch.inference_mode():
        baseline = _flat(apply_fn(strip_calibration(copy.deepcopy(model)), batch))
        results = []
        for g in quant_groups(model, depth):
            only = quantize_compute_params(model, predicate=lambda p, _s, g=g: p.startswith(g))
            d = float((_flat(apply_fn(only, batch)) - baseline).abs().mean())
            results.append((g, d if norm is None else d / norm))
    return sorted(results, key=lambda t: -t[1])


class CalibrationObserver:
    """Activation ranges for export to int8-native runtimes: a moving
    abs-max per name over batches."""

    def __init__(self, momentum: float = 0.9):
        self.momentum = momentum
        self.ranges: Dict[str, float] = {}

    def observe(self, name: str, x) -> None:
        amax = float(torch.as_tensor(x).detach().abs().max())
        if name in self.ranges:
            self.ranges[name] = self.momentum * self.ranges[name] + (1 - self.momentum) * amax
        else:
            self.ranges[name] = amax

    def scales(self) -> Dict[str, float]:
        return {k: v / 127.0 for k, v in self.ranges.items()}
