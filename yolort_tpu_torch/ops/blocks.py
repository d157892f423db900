"""YOLOv5 building blocks as ``nn.Module``s, float and int8 paths.

Port of ``yolort_tpu/ops/blocks.py`` (``hardsigmoid``, ``fuse_conv_bn``,
Conv, Conv2dOnly, BatchNorm, Bottleneck, C3, BottleneckCSP, SPP/SPPF,
``space_to_depth``, Focus, Linear, TransformerLayer, TransformerBlock,
C3TR, ``max_pool_same``, ``upsample2x``, the Ghost blocks (DWConv,
GhostConv, GhostBottleneck, C3Ghost), ``contract`` / ``expand``, Classify,
the MobileNetV3 blocks (SqueezeExcite, InvertedResidual), and the
int8-compute glue:
``QTensor``, ``_as_float``, ``_qconcat``, ``_qadd``; the JAX
``_quantize_input`` and ``_requantize`` are ``quantize_int8`` of the qconv
module, whose kernel epilogue does the requantize).  The other
activations are ``ACTS`` of ``ops/cuda/epilogue_kernel.py``, the plain
versions of the float convs' epilogue kernel (``fused_epilogue``).
Activations are NCHW in ``channels_last`` memory; weights are OIHW.  Child
names mirror the JAX params tree (``cv1``, ``m.0``, ...), so
``models/_bridge.py`` loads a JAX tree by walking it.

int8 compute: a quantized Conv / Conv2dOnly (``set_int8``, made by
``ops/quantization.py`` or the bridge) runs its conv through the
``qconv`` kernels, and a Conv with an output scale ``os`` hands the next
block a ``QTensor``, so the activations between convs stay int8.  Scales
are Python floats in two kinds, as in the JAX package.  Before
``finalize_scales`` they are ``ScaleLeaf``s, the port's form of the JAX
tree's runtime float32 scale arrays: the int8 glue computes with them in
float32 (``_qconcat``, ``_qadd``, ``inv_scale``), as JAX's runtime
branches do.  Afterwards they are plain floats, the JAX ``StaticScale``:
fixed constants, every concat group sharing one scale.

Initialisation draws from a ``torch.Generator`` on the CPU, so one seed
gives the same weights on every device; the model is moved to its device
once built.  ``init_train`` of a block redraws it in the JAX ``init`` form
that the trainer starts from: Conv unfused with an identity BatchNorm,
whose ``gamma``, ``beta``, ``mean`` and ``var`` are parameters like the
weights, as every leaf of the JAX params tree is trained.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolort_tpu_torch.ops.cuda.epilogue_kernel import ACTS, KINDS, bias_act_, leaky_relu01, relu
from yolort_tpu_torch.ops.cuda.qconv_kernel import pack_weight, qconv, quantize_int8
from yolort_tpu_torch.utils.graphs import eager_on_card
from yolort_tpu_torch.utils.profiling import count, span

# BatchNorm epsilon of the model zoo (as in the JAX package)
BN_EPS = 1e-3


def autopad(k: int, p: Optional[int] = None) -> int:
    """'same' padding rule."""
    return k // 2 if p is None else p


def hardsigmoid(x: torch.Tensor) -> torch.Tensor:
    """clip(x / 6 + 0.5, 0, 1), as the JAX package computes it (not
    ``F.hardsigmoid``'s relu6(x + 3) / 6, which rounds differently)."""
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def act_for_version(version: str) -> str:
    """r4.0 and r6.0 use SiLU, r3.1 Hardswish."""
    return "hardswish" if version == "r3.1" else "silu"


def fuse_conv_bn(w, gamma, beta, mean, var, eps: float = BN_EPS):
    """Fold eval-mode BatchNorm into HWIO conv weights and a bias, in
    float64, as ``yolort_tpu.ops.blocks.fuse_conv_bn`` does."""
    w, gamma, beta, mean, var = (np.asarray(a, np.float64) for a in (w, gamma, beta, mean, var))
    scale = gamma / np.sqrt(var + eps)
    return (w * scale).astype(np.float32), (beta - mean * scale).astype(np.float32)


def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * bound


def host_f32(a) -> np.ndarray:
    """A leaf of a JAX-layout params tree (numpy, or a torch tensor of any
    float dtype on any device) as a float32 numpy array."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, np.float32)


def _as_tensor(a, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(host_f32(a), device=like.device).to(like.dtype)


def _param(t: torch.Tensor, like: torch.Tensor) -> nn.Parameter:
    """``t`` as a parameter on ``like``'s device and dtype, requiring grad
    as ``like`` does."""
    return nn.Parameter(t.to(device=like.device, dtype=like.dtype),
                        requires_grad=like.requires_grad)


# an identity BatchNorm, JAX's init of the unfused form
BN_INIT = {"gamma": 1.0, "beta": 0.0, "mean": 0.0, "var": 1.0}
BN_NAMES = tuple(BN_INIT)


def _set_bn(module: nn.Module, values: Dict[str, torch.Tensor], like: torch.Tensor) -> None:
    """Register ``gamma``, ``beta``, ``mean``, ``var`` as parameters."""
    for name in BN_NAMES:
        module.register_parameter(name, _param(values[name], like))


# --- int8 compute path --------------------------------------------------

# scale-group discovery (quantization.finalize_scales): when set to a list,
# _qconcat records the scale objects of every concat's parts
_UNIFY: Optional[List[list]] = None


class ScaleLeaf(float):
    """A runtime activation scale (before ``finalize_scales``): a float32
    value whose object identity names the leaf it came from, as a scale
    array does in the JAX tree.  The int8 glue computes with it in float32,
    as JAX's runtime branches do; ``finalize_scales`` matches concat parts
    to leaves by identity and replaces every leaf with a plain float."""

    __slots__ = ()


def _runtime(*scales) -> bool:
    return any(isinstance(s, ScaleLeaf) for s in scales)


def inv_scale(s: float) -> float:
    """1 / s as the JAX package computes it: a float32 division for a
    runtime scale (``1.0 / s`` of an f32 array), a Python float's
    otherwise (``1.0 / s.v`` of a ``StaticScale``)."""
    return float(np.float32(1.0) / np.float32(s)) if isinstance(s, ScaleLeaf) else 1.0 / s


class QTensor(NamedTuple):
    """int8 activation flowing between quantized convs: ``q`` int8 NCHW in
    channels_last memory, value = q * s; ``s`` the per-tensor scale (a
    Python float); ``dtype`` the float compute dtype to dequantize into."""

    q: torch.Tensor
    s: float
    dtype: torch.dtype


def _as_float(x):
    """Dequantize a QTensor (identity on float tensors)."""
    if isinstance(x, QTensor):
        return x.q.to(x.dtype) * x.s
    return x


def _qconcat(parts, dim: int = 1):
    """Channel concat that stays int8 when every part is a QTensor: parts
    whose scale is below the largest are rescaled to it in the int8
    domain (none are once ``finalize_scales`` has unified the group);
    a float concat otherwise.  Runtime scales: parts that share one scale
    object concatenate as they are, else every part is rescaled by its
    float32 ratio to the float32 max, which is the result's new scale."""
    if all(isinstance(p, QTensor) for p in parts):
        if _UNIFY is not None:
            _UNIFY.append([p.s for p in parts])
        ft = parts[0].dtype
        if not _runtime(*(p.s for p in parts)):
            common = max(p.s for p in parts)
            qs = [p.q if p.s == common else quantize_int8(p.q.to(ft), p.s / common)
                  for p in parts]
            return QTensor(torch.cat(qs, dim=dim), float(common), ft)
        if all(p.s is parts[0].s for p in parts[1:]):
            return QTensor(torch.cat([p.q for p in parts], dim=dim), parts[0].s, ft)
        ss = [np.float32(p.s) for p in parts]
        common = max(ss)
        qs = [quantize_int8(p.q.to(ft), float(s / common)) for p, s in zip(parts, ss)]
        return QTensor(torch.cat(qs, dim=dim), ScaleLeaf(common), ft)
    return torch.cat([_as_float(p) for p in parts], dim=dim)


def _qadd(a, b, out_scale=None):
    """Residual add.  Both QTensor: an int8-domain add requantized to the
    calibrated post-add scale ``out_scale`` (else to the upper bound
    sa + sb); a float add otherwise.  ``out_scale`` is carried by
    reference: scale-group discovery matches scales by identity.  With a
    runtime scale among the three, as JAX's runtime branch: sa + sb and
    both ratios in float32, both parts multiplied."""
    if isinstance(a, QTensor) and isinstance(b, QTensor):
        ft = a.dtype
        if _runtime(a.s, b.s, out_scale):
            sa, sb = np.float32(a.s), np.float32(b.s)
            s = (ScaleLeaf(sa + sb) if out_scale is None else
                 out_scale if isinstance(out_scale, ScaleLeaf) else ScaleLeaf(out_scale))
            sv = np.float32(s)
            y = a.q.to(ft) * float(sa / sv) + b.q.to(ft) * float(sb / sv)
            return QTensor(torch.round(y).clamp_(-127.0, 127.0).to(torch.int8), s, ft)
        sval = a.s + b.s if out_scale is None else out_scale
        ta = a.q.to(ft) if a.s == sval else a.q.to(ft) * (a.s / sval)
        tb = b.q.to(ft) if b.s == sval else b.q.to(ft) * (b.s / sval)
        return QTensor(torch.round(ta + tb).clamp_(-127.0, 127.0).to(torch.int8), sval, ft)
    return _as_float(a) + _as_float(b)


def _f32_bits(a, device) -> torch.Tensor:
    """float32 values held as int32 bits, so ``Module.to(dtype)`` leaves
    them float32 (the epilogue's scale and bias stay f32, as in JAX)."""
    return torch.tensor(np.asarray(a, np.float32), device=device).view(torch.int32)


class _Int8Conv:
    """The int8 form shared by Conv and Conv2dOnly: buffers ``wq`` (Cout,
    Kpad) int8 packed for the qconv kernels, ``ws_bits`` / ``b_bits`` (the
    per-channel weight scale and the folded bias, float32 as int32 bits),
    and the activation scales ``xs`` (input) and ``os`` (output, or None:
    float out) as Python floats."""

    @property
    def quantized(self) -> bool:
        return "wq" in self._buffers

    def set_int8(self, wq: np.ndarray, ws, xs: float, os: Optional[float] = None, b=None) -> None:
        """Take the int8-compute form: ``wq`` HWIO int8, ``ws`` (Cout,), the
        scales, ``b`` (Cout,) or None.  Drops the float weights."""
        dev = next(t.device for t in (*self._parameters.values(), *self._buffers.values())
                   if t is not None)
        cout = wq.shape[3]
        for name in ("weight", "bias", *BN_NAMES):
            self._parameters.pop(name, None)
        self.register_buffer("wq", pack_weight(np.asarray(wq)).to(dev))
        self.register_buffer("ws_bits", _f32_bits(np.reshape(ws, cout), dev))
        self.register_buffer("b_bits", _f32_bits(np.zeros(cout) if b is None else b, dev))
        self.xs, self.os = xs, os

    def qconv_operands(self, x):
        """(xq, scale, bias, out_scale, float dtype) of this conv on input
        ``x``: a QTensor's own int8 values and scale, or a float tensor
        quantized under ``xs``; scale = f32(in_s) * ws."""
        if isinstance(x, QTensor):
            xq, in_s, ft = x.q, x.s, x.dtype
        else:
            xq, in_s, ft = quantize_int8(x, inv_scale(self.xs)), self.xs, x.dtype
        scale = self.ws_bits.view(torch.float32) * float(in_s)
        return xq, scale, self.b_bits.view(torch.float32), self.os, ft

    def _forward_int8(self, x, act: str):
        xq, scale, bias, os, ft = self.qconv_operands(x)
        y = qconv(xq, self.wq, scale, bias, k=self.k, stride=self.s, pad=self.pad, groups=self.g,
                  act=act, inv_out_scale=None if os is None else inv_scale(os), out_dtype=ft)
        return y if os is None else QTensor(y, os, ft)


def fused_epilogue(x: torch.Tensor) -> bool:
    """Whether a float conv with a bias, on input ``x``, adds the bias and
    applies its activation with the ``bias_act`` kernel, in place on the
    conv's output, rather than as ATen does (the bias passed to the conv,
    which cuDNN adds in a pass of its own, then the activation): ``x`` of a
    dtype the kernel stores (``KINDS``), ``eager_on_card`` (grad off,
    nothing tracing, exporting or intercepting: an exported or traced
    program keeps ATen's conv, add and activation), cuDNN on.  It reads the
    call alone, so a network's input decides for all of its convs."""
    return x.dtype in KINDS and eager_on_card(x) and torch._C._get_cudnn_enabled()


def _conv_bias_act(x, weight, bias, s, pad, g, act: str):
    """act(conv(x) + bias): where ``fused_epilogue`` holds, the conv without
    its bias, then ``bias_act_`` in place on its output (``channels_last``,
    as the networks hold their activations: an output in another layout is
    copied first); elsewhere ATen's conv with the bias, then
    ``ACTS[act]``."""
    if fused_epilogue(x):
        y = F.conv2d(x, weight, None, s, pad, 1, g)
        return bias_act_(y.contiguous(memory_format=torch.channels_last), bias, act)
    return ACTS[act](F.conv2d(x, weight, bias, s, pad, 1, g))


def biased_float_convs(module: nn.Module) -> int:
    """The float Conv / Conv2dOnly layers of ``module`` with a bias: those
    whose epilogue ``fused_epilogue`` decides."""
    n, todo = 0, [module]
    while todo:
        m = todo.pop()
        if isinstance(m, _Int8Conv) and not m.quantized and m._parameters.get("bias") is not None:
            n += 1
        todo += (c for c in m._modules.values() if c is not None)
    return n


class Conv2dOnly(_Int8Conv, nn.Module):
    """Bare conv with optional bias (the detection-head 1x1 convs)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, bias: bool = True, *, gen: torch.Generator):
        super().__init__()
        self.k, self.s, self.pad, self.g = k, s, autopad(k, p), g
        bound = 1.0 / math.sqrt(k * k * (c1 // g))  # torch's Conv2d default init
        self.weight = nn.Parameter(_uniform(gen, (c2, c1 // g, k, k), bound))
        self.bias = nn.Parameter(_uniform(gen, (c2,), bound)) if bias else None

    def set_params(self, p: Dict[str, np.ndarray]) -> None:
        """Load a JAX leaf {'w' HWIO[, 'b']}."""
        self.weight.data = _as_tensor(host_f32(p["w"]).transpose(3, 2, 0, 1), self.weight)
        self.bias = _param(_as_tensor(p["b"], self.weight), self.weight) if "b" in p else None

    def init_train(self, gen: torch.Generator) -> None:
        """JAX's init: weight and bias U(-b, b), b = 1/sqrt(fan_in)."""
        w = self.weight
        bound = 1.0 / math.sqrt(w[0].numel())
        self.weight = _param(_uniform(gen, w.shape, bound), w)
        if self.bias is not None:
            self.bias = _param(_uniform(gen, self.bias.shape, bound), w)

    def forward(self, x):
        if self.quantized:
            return self._forward_int8(x, "none")
        x = _as_float(x)
        if self.bias is None:
            return F.conv2d(x, self.weight, None, self.s, self.pad, 1, self.g)
        return _conv_bias_act(x, self.weight, self.bias, self.s, self.pad, self.g, "none")


class Conv(_Int8Conv, nn.Module):
    """Conv2d + BatchNorm + activation (``act``: a key of ``ACTS``).

    Two parameter forms, as in JAX: fused (``weight`` + ``bias``; random
    init folds the identity BatchNorm of a fresh model into the weight) or
    unfused (``weight`` + the BatchNorm parameters ``gamma``, ``beta``,
    ``mean``, ``var``, applied after the conv as ``y * scale + bias``:
    the train form, in which ``mean`` and ``var`` are trained by gradient
    like the rest, as in the JAX package).
    The int8 form applies ``act`` in the qconv kernels' float32 epilogue,
    which knows every key of ``ACTS``."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, act: str = "silu", *, gen: torch.Generator):
        super().__init__()
        self.k, self.s, self.pad, self.g = k, s, autopad(k, p), g
        self.act = act
        bound = 1.0 / math.sqrt(k * k * (c1 // g))
        w = _uniform(gen, (c2, c1 // g, k, k), bound) * (1.0 / math.sqrt(1.0 + BN_EPS))
        self.weight = nn.Parameter(w)
        self.bias: Optional[nn.Parameter] = nn.Parameter(torch.zeros(c2))

    def set_params(self, p: Dict[str, np.ndarray]) -> None:
        """Load a JAX leaf, fused {'w','b'} or unfused {'w','gamma','beta','mean','var'}."""
        w = self.weight
        w.data = _as_tensor(host_f32(p["w"]).transpose(3, 2, 0, 1), w)
        if "b" in p:
            self.bias = _param(_as_tensor(p["b"], w), w)
            for name in BN_NAMES:
                self._parameters.pop(name, None)
        else:
            self.bias = None
            _set_bn(self, {name: _as_tensor(p[name], w) for name in BN_NAMES}, w)

    def init_train(self, gen: torch.Generator) -> None:
        """JAX's init, the unfused form: weight U(-b, b), b = 1/sqrt(fan_in),
        and an identity BatchNorm."""
        w = self.weight
        self.weight = _param(_uniform(gen, w.shape, 1.0 / math.sqrt(w[0].numel())), w)
        self.bias = None
        _set_bn(self, {name: torch.full((w.shape[0],), v) for name, v in BN_INIT.items()}, w)

    def forward(self, x):
        if self.quantized:
            return self._forward_int8(x, self.act)
        x = _as_float(x)
        if self.bias is not None:
            return _conv_bias_act(x, self.weight, self.bias, self.s, self.pad, self.g, self.act)
        y = F.conv2d(x, self.weight, None, self.s, self.pad, 1, self.g)
        return ACTS[self.act](_batch_norm(y, self.gamma, self.beta, self.mean, self.var))


def _batch_norm(y, gamma, beta, mean, var):
    """Eval BatchNorm over NCHW channels: scale and shift computed in f32,
    cast to the activation type (as in JAX)."""
    scale = gamma.float() * torch.rsqrt(var.float() + BN_EPS)
    bias = beta.float() - mean.float() * scale
    return y * scale.to(y.dtype)[:, None, None] + bias.to(y.dtype)[:, None, None]


class BatchNorm(nn.Module):
    """Standalone eval BatchNorm (BottleneckCSP's gate on its concat):
    parameters ``gamma``, ``beta``, ``mean``, ``var``, trained like the
    JAX leaves."""

    def __init__(self, c: int):
        super().__init__()
        for name, v in BN_INIT.items():
            setattr(self, name, nn.Parameter(torch.full((c,), v)))

    def set_params(self, p: Dict[str, np.ndarray]) -> None:
        """Load a JAX leaf {'gamma', 'beta', 'mean', 'var'}."""
        _set_bn(self, {name: _as_tensor(p[name], self.gamma) for name in BN_NAMES}, self.gamma)

    def init_train(self, gen: torch.Generator) -> None:
        """JAX's init: the identity (draws nothing from ``gen``)."""
        g = self.gamma
        _set_bn(self, {name: torch.full(g.shape, v) for name, v in BN_INIT.items()}, g)

    def forward(self, x):
        return _batch_norm(x, self.gamma, self.beta, self.mean, self.var)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (+ residual when shapes allow)."""

    def __init__(self, c1: int, c2: int, shortcut: bool = True, g: int = 1, e: float = 0.5,
                 act: str = "silu", *, gen: torch.Generator):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, act=act, gen=gen)
        self.cv2 = Conv(c_, c2, 3, 1, g=g, act=act, gen=gen)
        self.add = shortcut and c1 == c2
        self.as_: Optional[float] = None  # calibrated post-add scale (JAX 'as')

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return _qadd(x, y, self.as_) if self.add else y


class C3(nn.Module):
    """CSP bottleneck with 3 convolutions."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, act: str = "silu", *, gen: torch.Generator):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, act=act, gen=gen)
        self.cv2 = Conv(c1, c_, 1, 1, act=act, gen=gen)
        self.cv3 = Conv(2 * c_, c2, 1, act=act, gen=gen)
        self.m = nn.ModuleList(self.inner(c_, shortcut, g, act, gen) for _ in range(n))

    @staticmethod
    def inner(c_: int, shortcut: bool, g: int, act: str, gen: torch.Generator) -> nn.Module:
        return Bottleneck(c_, c_, shortcut, g, e=1.0, act=act, gen=gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = self.cv1(x)
        for b in self.m:
            y1 = b(y1)
        return self.cv3(_qconcat([y1, self.cv2(x)]))


class BottleneckCSP(nn.Module):
    """The r3.1 CSP bottleneck: Hardswish convs, raw 1x1 convs on both
    branches, BatchNorm + LeakyReLU(0.1) on their concat."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, *, gen: torch.Generator):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, act="hardswish", gen=gen)
        self.cv2 = Conv2dOnly(c1, c_, 1, 1, bias=False, gen=gen)
        self.cv3 = Conv2dOnly(c_, c_, 1, 1, bias=False, gen=gen)
        self.cv4 = Conv(2 * c_, c2, 1, 1, act="hardswish", gen=gen)
        self.bn = BatchNorm(2 * c_)
        self.m = nn.ModuleList(Bottleneck(c_, c_, shortcut, g, e=1.0, act="hardswish", gen=gen)
                               for _ in range(n))

    def forward(self, x):
        y1 = self.cv1(x)
        for b in self.m:
            y1 = b(y1)
        y = torch.cat([_as_float(self.cv3(y1)), _as_float(self.cv2(x))], dim=1)
        return self.cv4(leaky_relu01(self.bn(y)))


def max_pool_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k max pool, stride 1, padded by k//2 with -inf."""
    return F.max_pool2d(x, k, 1, k // 2)


class SPP(nn.Module):
    """Spatial pyramid pooling.  The default k=(5, 9, 13) is computed as a
    chain of three 5x5 pools (the SPPF identity); other kernel sizes pool
    the input once each."""

    def __init__(self, c1: int, c2: int, k: Sequence[int] = (5, 9, 13), act: str = "silu", *,
                 gen: torch.Generator):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = Conv(c1, c_, 1, 1, act=act, gen=gen)
        self.cv2 = Conv(c_ * (len(self.k) + 1), c2, 1, 1, act=act, gen=gen)

    def forward(self, x):
        x = self.cv1(x)
        if self.k == (5, 9, 13):
            y1 = _pool5(x)
            y2 = _pool5(y1)
            pooled = [y1, y2, _pool5(y2)]
        else:
            pooled = [_pool(x, k) for k in self.k]
        return self.cv2(_qconcat([x, *pooled]))


def SPPF(c1: int, c2: int, k: int = 5, act: str = "silu", *, gen: torch.Generator) -> SPP:
    """SPPF: the parameters of SPP with k=(5, 9, 13)."""
    if k != 5:
        raise ValueError(f"SPPF takes k=5, got {k}")
    return SPP(c1, c2, act=act, gen=gen)


def _pool(v, k: int):
    """SPP's k x k pool.  Max commutes with dequantization, so a QTensor
    pools its int8 values under the same scale (in the compute dtype,
    which holds every int8 value exactly)."""
    if isinstance(v, QTensor):
        return QTensor(max_pool_same(v.q.to(v.dtype), k).to(torch.int8), v.s, v.dtype)
    return max_pool_same(v, k)


def _pool5(v):
    return _pool(v, 5)


def upsample2x(x):
    """Nearest-neighbour 2x upsample; a QTensor keeps its scale.  int8 is
    repeated through the NHWC view (``F.interpolate`` takes no int8)."""
    if isinstance(x, QTensor):
        v = x.q.permute(0, 2, 3, 1)
        n, h, w, c = v.shape
        v = v[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)
        return QTensor(v.permute(0, 3, 1, 2), x.s, x.dtype)
    return F.interpolate(x, scale_factor=2.0, mode="nearest")


def space_to_depth(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, 4C, H/2, W/2) in YOLOv5's Focus channel order:
    the pixels (0, 0), (1, 0), (0, 1), (1, 1) of each 2x2 patch, as (row,
    column) offsets."""
    parts = [x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2], x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]]
    return torch.cat(parts, dim=1)


class Focus(nn.Module):
    """``space_to_depth`` then a Conv (the r3.1 / r4.0 stem)."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, p: Optional[int] = None,
                 g: int = 1, act: str = "silu", *, gen: torch.Generator):
        super().__init__()
        self.s = s
        self.conv = Conv(c1 * 4, c2, k, s, p, g, act=act, gen=gen)

    def forward(self, x):
        return self.conv(space_to_depth(_as_float(x)))


# --- transformer blocks (C3TR, the TAN variant) ---------------------------

class Linear(nn.Module):
    """x @ w (+ b); ``weight`` is held (out, in) as in torch, the JAX leaf
    {'w' (in, out)[, 'b']}."""

    def __init__(self, cin: int, cout: int, bias: bool = True, *, gen: torch.Generator):
        super().__init__()
        bound = 1.0 / math.sqrt(cin)
        self.weight = nn.Parameter(_uniform(gen, (cout, cin), bound))
        self.bias = nn.Parameter(_uniform(gen, (cout,), bound)) if bias else None

    def set_params(self, p: Dict[str, np.ndarray]) -> None:
        self.weight.data = _as_tensor(host_f32(p["w"]).T, self.weight)
        self.bias = _param(_as_tensor(p["b"], self.weight), self.weight) if "b" in p else None

    def init_train(self, gen: torch.Generator) -> None:
        """JAX's init: weight and bias U(-b, b), b = 1/sqrt(in)."""
        w = self.weight
        bound = 1.0 / math.sqrt(w.shape[1])
        self.weight = _param(_uniform(gen, w.shape, bound), w)
        if self.bias is not None:
            self.bias = _param(_uniform(gen, self.bias.shape, bound), w)

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class TransformerLayer(nn.Module):
    """LayerNorm-free transformer layer on (L, N, C) tokens: q/k/v Linears,
    then the input projection, scaled dot-product attention and output
    projection of ``torch.nn.MultiheadAttention``, written as matmuls and a
    softmax as the JAX package writes them, then two Linears; both with a
    residual.  ``in_proj_w`` (3C, C) and ``in_proj_b`` (3C,) are the JAX
    keys of the attention's input projection."""

    def __init__(self, c: int, num_heads: int, *, gen: torch.Generator):
        super().__init__()
        self.num_heads = num_heads
        self.q = Linear(c, c, bias=False, gen=gen)
        self.k = Linear(c, c, bias=False, gen=gen)
        self.v = Linear(c, c, bias=False, gen=gen)
        self.in_proj_w = nn.Parameter(torch.empty(3 * c, c))
        self.in_proj_b = nn.Parameter(torch.zeros(3 * c))
        self.init_train(gen)
        self.out_proj = Linear(c, c, bias=True, gen=gen)
        self.fc1 = Linear(c, c, bias=False, gen=gen)
        self.fc2 = Linear(c, c, bias=False, gen=gen)

    def init_train(self, gen: torch.Generator) -> None:
        """The attention's input projection as JAX inits it: xavier_uniform
        weight (as ``nn.MultiheadAttention``), zero bias.  The Linears draw
        their own."""
        w = self.in_proj_w
        c = w.shape[1]
        self.in_proj_w = _param(_uniform(gen, w.shape, math.sqrt(6.0 / (c + 3 * c))), w)
        self.in_proj_b = _param(torch.zeros(3 * c), w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        L, N, c = x.shape
        h = self.num_heads
        hd = c // h
        wq, wk, wv = self.in_proj_w.chunk(3, dim=0)
        bq, bk, bv = self.in_proj_b.chunk(3, dim=0)
        q = self.q(x) @ wq.T + bq
        k = self.k(x) @ wk.T + bk
        v = self.v(x) @ wv.T + bv

        def heads(t):  # (L, N, C) -> (N*h, L, hd)
            return t.reshape(L, N * h, hd).transpose(0, 1)

        attn = torch.softmax((heads(q) * (1.0 / math.sqrt(hd))) @ heads(k).transpose(1, 2), dim=-1)
        out = (attn @ heads(v)).transpose(0, 1).reshape(L, N, c)
        x = self.out_proj(out) + x
        return self.fc2(self.fc1(x)) + x


class TransformerBlock(nn.Module):
    """A Linear position term, then ``num_layers`` TransformerLayers over
    the feature map's pixels as tokens, in row-major order, all inside
    span ``attention``, with count ``attention_tokens`` (B·H·W) once a
    call.  (The JAX block's Conv for c1 != c2 is not ported: C3TR, its
    one caller, keeps the width.)"""

    # its span and counter are Python, which a CUDA graph's replay does not
    # run: a network that holds one runs eagerly (utils/graphs.py)
    EAGER_ONLY = True

    def __init__(self, c: int, num_heads: int, num_layers: int, *, gen: torch.Generator):
        super().__init__()
        self.linear = Linear(c, c, bias=True, gen=gen)
        self.tr = nn.ModuleList(TransformerLayer(c, num_heads, gen=gen) for _ in range(num_layers))

    def forward(self, x):
        x = _as_float(x)
        n, c, h, w = x.shape
        with span("attention"):
            count("attention_tokens", n * h * w)
            tokens = x.flatten(2).permute(2, 0, 1)  # (H*W, N, C)
            tokens = tokens + self.linear(tokens)
            for layer in self.tr:
                tokens = layer(tokens)
            y = tokens.permute(1, 2, 0).reshape(n, c, h, w)
            return y.contiguous(memory_format=torch.channels_last)


class C3TR(nn.Module):
    """C3 with a 4-head TransformerBlock in place of its Bottlenecks."""

    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True, g: int = 1,
                 e: float = 0.5, *, gen: torch.Generator):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = Conv(c1, c_, 1, 1, gen=gen)
        self.cv2 = Conv(c1, c_, 1, 1, gen=gen)
        self.cv3 = Conv(2 * c_, c2, 1, gen=gen)
        self.m = TransformerBlock(c_, 4, n, gen=gen)

    def forward(self, x):
        return self.cv3(_qconcat([self.m(self.cv1(x)), self.cv2(x)]))


# --- the Ghost, MobileNetV3 and classification blocks ----------------------

def DWConv(c1: int, c2: int, k: int = 1, s: int = 1, act: str = "silu", *,
           gen: torch.Generator) -> Conv:
    """Depth-wise convolution: a Conv with groups = gcd(c1, c2)."""
    return Conv(c1, c2, k, s, g=math.gcd(c1, c2), act=act, gen=gen)


class GhostConv(nn.Module):
    """Ghost convolution: half the channels from a primary conv, half from
    a cheap 5x5 depth-wise conv on those."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1, act: str = "silu", *,
                 gen: torch.Generator):
        super().__init__()
        c_ = c2 // 2
        self.s = s
        self.cv1 = Conv(c1, c_, k, s, act=act, gen=gen)
        self.cv2 = Conv(c_, c_, 5, 1, g=c_, act=act, gen=gen)

    def forward(self, x):
        y = self.cv1(x)
        return _qconcat([y, self.cv2(y)])


class GhostBottleneck(nn.Module):
    """Ghost bottleneck: GhostConv, a depth-wise stride-2 conv when s=2,
    GhostConv; the shortcut is the input, or at s=2 a depth-wise conv and
    a 1x1 conv of it."""

    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 1, *, gen: torch.Generator):
        super().__init__()
        c_ = c2 // 2
        self.s = s
        conv = [GhostConv(c1, c_, 1, 1, gen=gen)]
        if s == 2:
            conv.append(DWConv(c_, c_, k, s, act="none", gen=gen))
        conv.append(GhostConv(c_, c2, 1, 1, act="none", gen=gen))
        self.conv = nn.ModuleList(conv)
        self.shortcut = nn.ModuleList([DWConv(c1, c1, k, s, act="none", gen=gen),
                                       Conv(c1, c2, 1, 1, act="none", gen=gen)]) if s == 2 else None

    def forward(self, x):
        y = x
        for m in self.conv:
            y = m(y)
        s = x
        for m in self.shortcut or ():
            s = m(s)
        return _qadd(y, s)


class C3Ghost(C3):
    """C3 with GhostBottleneck inner blocks."""

    @staticmethod
    def inner(c_: int, shortcut: bool, g: int, act: str, gen: torch.Generator) -> nn.Module:
        return GhostBottleneck(c_, c_, gen=gen)


def contract(x, gain: int = 2):
    """(N, C, H, W) -> (N, C*g*g, H/g, W/g), channels in the JAX package's
    NHWC order (row offset, column offset, channel); a QTensor keeps its
    scale."""
    if isinstance(x, QTensor):
        return QTensor(contract(x.q, gain), x.s, x.dtype)
    n, c, h, w = x.shape
    g = gain
    y = x.reshape(n, c, h // g, g, w // g, g).permute(0, 3, 5, 1, 2, 4)
    return y.reshape(n, g * g * c, h // g, w // g).contiguous(memory_format=torch.channels_last)


def expand(x, gain: int = 2):
    """(N, C, H, W) -> (N, C/(g*g), H*g, W*g), the inverse of ``contract``."""
    if isinstance(x, QTensor):
        return QTensor(expand(x.q, gain), x.s, x.dtype)
    n, c, h, w = x.shape
    g = gain
    y = x.reshape(n, g, g, c // (g * g), h, w).permute(0, 3, 4, 1, 5, 2)
    return y.reshape(n, c // (g * g), h * g, w * g).contiguous(memory_format=torch.channels_last)


def _pooled(x: torch.Tensor) -> torch.Tensor:
    """The (N, C, 1, 1) spatial mean, laid out channels_last (a 1x1 map's
    strides allow either layout; an int8 conv of it needs NHWC bytes)."""
    return x.mean((2, 3), keepdim=True).contiguous(memory_format=torch.channels_last)


class Classify(nn.Module):
    """Classification head: global average pool, then a 1x1 conv; (N, c2)."""

    def __init__(self, c1: int, c2: int, *, gen: torch.Generator):
        super().__init__()
        self.conv = Conv2dOnly(c1, c2, 1, bias=True, gen=gen)

    def forward(self, x):
        x = _as_float(x)
        return self.conv(_pooled(x)).reshape(x.shape[0], -1)


class SqueezeExcite(nn.Module):
    """Squeeze-and-excitation, MobileNetV3 style: pool, 1x1 conv, relu, 1x1
    conv, ``hardsigmoid`` gate on the input."""

    def __init__(self, c: int, squeeze: int, *, gen: torch.Generator):
        super().__init__()
        self.fc1 = Conv2dOnly(c, squeeze, 1, bias=True, gen=gen)
        self.fc2 = Conv2dOnly(squeeze, c, 1, bias=True, gen=gen)

    def forward(self, x):
        x = _as_float(x)
        s = relu(self.fc1(_pooled(x)))
        return x * hardsigmoid(self.fc2(s))



class InvertedResidual(nn.Module):
    """MobileNetV3 inverted residual: ``expand`` 1x1 (when exp != cin),
    ``dw`` depth-wise kxk, ``se`` (``use_se``), ``project`` 1x1; the
    residual only when s == 1 and cin == cout."""

    def __init__(self, cin: int, exp: int, cout: int, k: int = 3, s: int = 1, use_se: bool = False,
                 act: str = "hardswish", *, gen: torch.Generator):
        super().__init__()
        self.add = s == 1 and cin == cout
        if exp != cin:
            self.expand = Conv(cin, exp, 1, act=act, gen=gen)
        self.dw = Conv(exp, exp, k, s, g=exp, act=act, gen=gen)
        if use_se:
            self.se = SqueezeExcite(exp, _make_div8(exp // 4), gen=gen)
        self.project = Conv(exp, cout, 1, act="none", gen=gen)

    def forward(self, x):
        y = x
        for m in self.children():
            y = m(y)
        return _qadd(x, y) if self.add else y


def _make_div8(v: int) -> int:
    nv = max(8, int(v + 4) // 8 * 8)
    return nv + 8 if nv < 0.9 * v else nv


TRAIN_BLOCKS = (Conv, Conv2dOnly, BatchNorm, Linear, TransformerLayer)


def init_train(module: nn.Module, gen: torch.Generator) -> None:
    """Redraw every block of ``module`` in JAX's ``init`` form, in module
    order from ``gen``."""
    from yolort_tpu_torch.ops import experimental  # it imports this module

    for m in module.modules():
        if isinstance(m, TRAIN_BLOCKS + experimental.TRAIN_BLOCKS):
            m.init_train(gen)
