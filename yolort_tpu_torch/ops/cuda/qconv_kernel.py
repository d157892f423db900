"""int8 convolution kernels: ``qconv1x1``, ``qconv_kxk`` and
``qconv_grouped`` (``csrc/qconv.cu``), each with its plain PyTorch version.

Replace ``yolort_tpu/ops/pallas/qconv.py``: ``qconv1x1`` and ``qconv3x3``
with their shared ``_epilogue``.  On the TPU the Pallas kernels are an
opt-in beside XLA's s8 conv; core PyTorch has no int8 CUDA convolution, so
here they are the int8 conv itself: ``qconv_kxk`` also runs the strided
3x3 downsamples and the 6x6/s2/p2 stem, and ``qconv_grouped`` the grouped
convs (depth-wise, DWConv, GhostConv's cheap half), which the JAX package
sends to XLA's s8 conv.

Activations are int8 NCHW in ``channels_last`` memory (NHWC bytes).
Weights are packed once, at quantization, to (Cout, Kpad) int8 with
K = k*k*Cin/G in (ky, kx, ci-within-group) order and zero-padded to a
multiple of 4 (``pack_weight``).  On the card the ungrouped convs run one
implicit-GEMM kernel on the int8 tensor cores, fed by a ``cp.async``
ring; ``qconv_plan`` picks its tile and loader from the conv's shape.
The grouped ones run a direct conv, four output channels a thread.  The
epilogue, in float32, is

    y = f32(acc) * scale[co] + bias[co];  y = act(y)
    act: none | silu (y * sigmoid(y)) | hardswish (y * clip(y + 3, 0, 6) / 6)
         | leaky_relu (where(y >= 0, y, 0.1 * y)) | relu (max(y, 0))
    out = clip(round_half_even(y * inv_out_scale), -127, 127) as int8

or ``y`` cast to ``out_dtype`` when ``inv_out_scale`` is None.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from yolort_tpu_torch.ops.cuda import _build

# the epilogue's activations and their codes in csrc/act.cuh, which the
# float convs' epilogue shares (the activations of the JAX package's qconv
# ``_act``, and its blocks' relu)
ACTS = {"none": 0, "silu": 1, "hardswish": 2, "leaky_relu": 3, "relu": 4}
# the float32 constants of the JAX program's weak-typed 1/6 and 0.1
ONE_SIXTH = float(np.float32(1.0 / 6.0))
LEAKY_SLOPE = float(np.float32(0.1))
_OUT_KINDS = {torch.int8: 0, torch.float32: 1, torch.bfloat16: 2}

# the kernel's geometry (csrc/qconv.cu): K bytes per pipeline stage, ring
# depth, and the output tiles (BM, BN) by index, as its launch switch
# lists them
BK = 64
STAGES = 4
TILES = ((128, 128), (128, 64), (128, 32), (64, 128), (64, 64))
NUM_SMS = 132  # H100 SXM
MAX_SMEM = 232_448  # shared memory a block can take on Hopper
# the largest K whose s32 accumulator cannot overflow: |acc| <= K * 128^2
MAX_DEPTH = (2**31 - 1) // (128 * 128)


class QconvPlan(NamedTuple):
    """How the kernel runs one conv: tile index into ``TILES``, its shape,
    the loader (``gather`` for C % 16 != 0 or rows not 16-byte aligned,
    else ``cp.async``), the K slabs (the last zero-filled past K), the
    dynamic shared memory and the grid of output tiles (M tiles, Cout
    tiles), one block each."""

    tile: int
    bm: int
    bn: int
    gather: bool
    slabs: int
    smem: int
    tiles: tuple


def tile_smem(bm: int, bn: int) -> int:
    """Shared memory of a tile: the ring of A and B slabs, which then holds
    the output tile, staged at up to 4 bytes a value with 16 bytes of row
    padding."""
    return max(STAGES * (bm + bn) * BK, bm * (bn * 4 + 16))


def qconv_plan(m: int, cout: int, depth: int, cin: int, kpad: int,
               aligned: bool = True) -> QconvPlan:
    """The kernel's plan for an (m pixels) x (cout) conv of K = ``depth``
    over ``cin`` channels, with weight rows of ``kpad`` bytes.

    The gather loader (C % 16 != 0, rows not 16-byte aligned, or
    ``aligned`` False: a pointer not 16-byte aligned) runs on the stem's
    tile, 128 x 32.  Otherwise BN is the smallest of 32 / 64 / 128 covering
    Cout (128 above), then the first of (128, BN), (64, BN), (64, BN / 2)
    that is a tile and gives a block to every SM; where none does, the one
    with the most blocks."""
    gather = bool(cin % 16 or kpad % 16 or not aligned)
    bn = 32 if cout <= 32 else 64 if cout <= 64 else 128
    shapes = [t for t in ((128, bn), (64, bn), (64, bn // 2)) if t in TILES]
    blocks = [-(-m // bm) * -(-cout // b) for bm, b in shapes]
    pick = next((i for i, nb in enumerate(blocks) if nb >= NUM_SMS),
                max(range(len(shapes)), key=blocks.__getitem__))
    bm, bn = (128, 32) if gather else shapes[pick]
    return QconvPlan(tile=TILES.index((bm, bn)), bm=bm, bn=bn, gather=gather,
                     slabs=-(-depth // BK), smem=tile_smem(bm, bn),
                     tiles=(-(-m // bm), -(-cout // bn)))


def padded_depth(k: int, cin: int) -> int:
    """Kpad: the reduction depth k*k*cin rounded up to a multiple of 4."""
    return -(-(k * k * cin) // 4) * 4


def pack_weight(w_hwio: np.ndarray) -> torch.Tensor:
    """HWIO int8 weights (k, k, cin/G, cout) -> (cout, Kpad) int8, K =
    k*k*cin/G in (ky, kx, ci-within-group) order, zero-padded to a
    multiple of 4 (a grouped conv's HWIO already holds one group's
    channels)."""
    kh, kw, cin, cout = w_hwio.shape
    if kh != kw:
        raise ValueError(f"square kernels only, got {kh}x{kw}")
    rows = np.asarray(w_hwio, np.int8).transpose(3, 0, 1, 2).reshape(cout, -1)
    out = np.zeros((cout, padded_depth(kh, cin)), np.int8)
    out[:, : rows.shape[1]] = rows
    return torch.from_numpy(out)


def quantize_int8(x: torch.Tensor, inv_scale: float) -> torch.Tensor:
    """clip(round_half_even(x * inv_scale), -127, 127) as int8, computed in
    x's dtype (the requantize of the JAX package, ``blocks._requantize``)."""
    return torch.round(x * inv_scale).clamp_(-127.0, 127.0).to(torch.int8)


def _epilogue(acc: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, act: str,
              inv_out_scale: Optional[float], out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's epilogue, one rounded float32 operation at a time."""
    y = acc.to(torch.float32) * scale.view(1, -1, 1, 1)
    y = y + bias.view(1, -1, 1, 1)
    if act == "silu":
        y = y * torch.sigmoid(y)
    elif act == "hardswish":
        y = (y * torch.clamp(y + 3.0, 0.0, 6.0)) * ONE_SIXTH
    elif act == "leaky_relu":
        y = torch.where(y >= 0, y, y * LEAKY_SLOPE)
    elif act == "relu":
        y = torch.clamp_min(y, 0.0)
    if inv_out_scale is not None:
        return quantize_int8(y, inv_out_scale)
    return y.to(out_dtype)


def _check(xq, wq, scale, bias, k, act, inv_out_scale, out_dtype, name, groups=1):
    if xq.dim() != 4 or xq.dtype != torch.int8:
        raise ValueError(f"{name}: xq must be (N, C, H, W) int8, got {tuple(xq.shape)} {xq.dtype}")
    cout = scale.shape[0] if scale.dim() == 1 else -1
    if groups < 1 or xq.shape[1] % groups or cout % groups:
        raise ValueError(f"{name}: groups={groups} must divide Cin={xq.shape[1]} and Cout={cout}")
    cin = xq.shape[1] // groups  # the reduction's channels: one group's
    if wq.dtype != torch.int8 or tuple(wq.shape) != (cout, padded_depth(k, cin)):
        raise ValueError(f"{name}: wq must be ({cout}, {padded_depth(k, cin)}) int8 for k={k}, "
                         f"cin/groups={cin}, got {tuple(wq.shape)} {wq.dtype}")
    for t, what in ((scale, "scale"), (bias, "bias")):
        if t.dtype != torch.float32 or tuple(t.shape) != (cout,):
            raise ValueError(f"{name}: {what} must be ({cout},) float32, got {tuple(t.shape)} {t.dtype}")
    if act not in ACTS:
        raise ValueError(f"{name}: act must be one of {sorted(ACTS)}, got {act!r}")
    want = torch.int8 if inv_out_scale is not None else out_dtype
    if want not in _OUT_KINDS:
        raise ValueError(f"{name}: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if len({t.device for t in (xq, wq, scale, bias)}) != 1:
        raise ValueError(f"{name}: all tensors must be on one device")
    if k * k * cin > MAX_DEPTH:
        raise ValueError(f"{name}: K = {k * k * cin} > {MAX_DEPTH}: the s32 accumulator "
                         f"|acc| <= K * 128^2 could reach 2^31")
    return want


def qconv1x1_reference(xq, wq, scale, bias, *, act="silu", inv_out_scale=None,
                       out_dtype=torch.float32):
    """Plain version of ``qconv1x1``: the exact s32 accumulator as a
    float64 matmul over NHWC rows (|acc| <= Cin * 127^2 < 2^53), then the
    epilogue."""
    n, c, h, w = xq.shape
    rows = xq.permute(0, 2, 3, 1).reshape(-1, c).double()
    acc = (rows @ wq.double().t()).to(torch.int32)
    acc = acc.view(n, h, w, -1).permute(0, 3, 1, 2)
    return _epilogue(acc, scale, bias, act, inv_out_scale, out_dtype).contiguous(
        memory_format=torch.channels_last)


def qconv_kxk_reference(xq, wq, scale, bias, *, k, stride=1, pad=None, act="silu",
                        inv_out_scale=None, out_dtype=torch.float32):
    """Plain version of ``qconv_kxk``: ``qconv_grouped_reference`` in one
    group."""
    return qconv_grouped_reference(xq, wq, scale, bias, k=k, stride=stride, pad=pad, groups=1,
                                   act=act, inv_out_scale=inv_out_scale, out_dtype=out_dtype)


def qconv_grouped_reference(xq, wq, scale, bias, *, k, stride=1, pad=None, groups,
                            act="silu", inv_out_scale=None, out_dtype=torch.float32):
    """Plain version of ``qconv_grouped``: the exact s32 accumulator as a
    float64 grouped ``F.conv2d`` of the int8 values, then the epilogue."""
    pad = k // 2 if pad is None else pad
    cout, cin_g = wq.shape[0], xq.shape[1] // groups
    w = wq[:, : k * k * cin_g].reshape(cout, k, k, cin_g).permute(0, 3, 1, 2).double()
    acc = F.conv2d(xq.double(), w, None, stride, pad, 1, groups).to(torch.int32)
    return _epilogue(acc, scale, bias, act, inv_out_scale, out_dtype).contiguous(
        memory_format=torch.channels_last)


def _launch_setup(xq, wq, scale, bias, name):
    if xq.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not {xq.device}")
    if not xq.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{name} needs xq in channels_last memory (NHWC bytes)")
    if not (wq.is_contiguous() and scale.is_contiguous() and bias.is_contiguous()):
        raise ValueError(f"{name} needs contiguous wq, scale and bias")
    if wq.data_ptr() % 4:
        raise ValueError(f"{name} needs a 4-byte aligned wq (the kernel loads int8x4 words)")


def _plan_for(xq, wq, out, k: int) -> QconvPlan:
    aligned = xq.data_ptr() % 16 == 0 and wq.data_ptr() % 16 == 0
    n, cout, ho, wo = out.shape
    return qconv_plan(n * ho * wo, cout, k * k * xq.shape[1], xq.shape[1], wq.shape[1], aligned)


def qconv1x1(xq, wq, scale, bias, *, act="silu", inv_out_scale=None, out_dtype=torch.float32):
    """1x1 stride-1 int8 conv with the fused epilogue.

    xq (N, Cin, H, W) int8 channels_last, Cin % 4 == 0; wq (Cout, Cin) int8
    packed; scale, bias (Cout,) float32.  Returns (N, Cout, H, W)
    channels_last: int8 when ``inv_out_scale`` is given, else ``out_dtype``.
    CUDA tensors launch the kernel on the current stream; CPU tensors take
    ``qconv1x1_reference``."""
    out_t = _check(xq, wq, scale, bias, 1, act, inv_out_scale, out_dtype, "qconv1x1")
    if xq.device.type == "cpu":
        return qconv1x1_reference(xq, wq, scale, bias, act=act, inv_out_scale=inv_out_scale,
                                  out_dtype=out_dtype)
    _launch_setup(xq, wq, scale, bias, "qconv1x1")
    n, c, h, w = xq.shape
    if c % 4:
        raise ValueError(f"qconv1x1 needs Cin % 4 == 0, got Cin={c}")
    cout = wq.shape[0]
    out = torch.empty((n, cout, h, w), dtype=out_t, device=xq.device,
                      memory_format=torch.channels_last)
    plan = _plan_for(xq, wq, out, 1)
    _build.launch(
        qconv1x1, "yt_qconv1x1", xq, xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), float(inv_out_scale or 0.0), out.data_ptr(), n, h, w, c, cout, ACTS[act],
        _OUT_KINDS[out_t], plan.tile, int(plan.gather), plan.smem,
    )
    return out


qconv1x1.launches = 0


def qconv_kxk(xq, wq, scale, bias, *, k, stride=1, pad=None, act="silu", inv_out_scale=None,
              out_dtype=torch.float32):
    """k x k int8 conv (any stride and zero padding, groups 1) with the
    fused epilogue, as an implicit GEMM.

    xq (N, Cin, H, W) int8 channels_last; wq (Cout, Kpad) int8 packed by
    ``pack_weight``; scale, bias (Cout,) float32; ``pad`` defaults to k//2.
    Returns (N, Cout, Ho, Wo) channels_last, int8 or ``out_dtype``.  CUDA
    tensors launch the kernel; CPU tensors take ``qconv_kxk_reference``."""
    pad = k // 2 if pad is None else pad
    out_t = _check(xq, wq, scale, bias, k, act, inv_out_scale, out_dtype, "qconv_kxk")
    if stride < 1 or pad < 0:
        raise ValueError(f"qconv_kxk: stride must be >= 1 and pad >= 0, got {stride}, {pad}")
    if xq.device.type == "cpu":
        return qconv_kxk_reference(xq, wq, scale, bias, k=k, stride=stride, pad=pad, act=act,
                                   inv_out_scale=inv_out_scale, out_dtype=out_dtype)
    _launch_setup(xq, wq, scale, bias, "qconv_kxk")
    n, c, h, w = xq.shape
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    cout = wq.shape[0]
    out = torch.empty((n, cout, ho, wo), dtype=out_t, device=xq.device,
                      memory_format=torch.channels_last)
    plan = _plan_for(xq, wq, out, k)
    _build.launch(
        qconv_kxk, "yt_qconv_kxk", xq, xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), float(inv_out_scale or 0.0), out.data_ptr(), n, h, w, c, cout, k, stride,
        pad, ho, wo, ACTS[act], _OUT_KINDS[out_t], plan.tile, int(plan.gather), plan.smem,
    )
    return out


qconv_kxk.launches = 0


def qconv_grouped(xq, wq, scale, bias, *, k, stride=1, pad=None, groups, act="silu",
                  inv_out_scale=None, out_dtype=torch.float32):
    """k x k int8 conv in ``groups`` groups (any stride and zero padding)
    with the fused epilogue, as a direct conv.

    xq (N, Cin, H, W) int8 channels_last; group g reads channels [g*Cin/G,
    (g+1)*Cin/G) and writes output channels [g*Cout/G, (g+1)*Cout/G); wq
    (Cout, Kpad) int8 packed by ``pack_weight`` from the (k, k, Cin/G,
    Cout) HWIO weights; scale, bias (Cout,) float32.  Returns (N, Cout, Ho,
    Wo) channels_last, int8 or ``out_dtype``.  CUDA tensors launch the
    kernel; CPU tensors take ``qconv_grouped_reference``."""
    pad = k // 2 if pad is None else pad
    out_t = _check(xq, wq, scale, bias, k, act, inv_out_scale, out_dtype, "qconv_grouped",
                   groups)
    if stride < 1 or pad < 0:
        raise ValueError(f"qconv_grouped: stride must be >= 1 and pad >= 0, got {stride}, {pad}")
    if xq.device.type == "cpu":
        return qconv_grouped_reference(xq, wq, scale, bias, k=k, stride=stride, pad=pad,
                                       groups=groups, act=act, inv_out_scale=inv_out_scale,
                                       out_dtype=out_dtype)
    _launch_setup(xq, wq, scale, bias, "qconv_grouped")
    n, c, h, w = xq.shape
    ho = (h + 2 * pad - k) // stride + 1
    wo = (w + 2 * pad - k) // stride + 1
    cout = wq.shape[0]
    out = torch.empty((n, cout, ho, wo), dtype=out_t, device=xq.device,
                      memory_format=torch.channels_last)
    _build.launch(
        qconv_grouped, "yt_qconv_grouped", xq, xq.data_ptr(), wq.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), float(inv_out_scale or 0.0), out.data_ptr(), n, h, w, c, cout, k, stride,
        pad, ho, wo, groups, ACTS[act], _OUT_KINDS[out_t],
    )
    return out


qconv_grouped.launches = 0


def qconv(xq, wq, scale, bias, *, k, stride=1, pad=None, groups=1, act="silu",
          inv_out_scale=None, out_dtype=torch.float32):
    """The int8 conv of a quantized Conv: grouped convs go to
    ``qconv_grouped``, 1x1 stride-1 unpadded ones to ``qconv1x1``, every
    other shape to ``qconv_kxk``."""
    pad = k // 2 if pad is None else pad
    kw = dict(act=act, inv_out_scale=inv_out_scale, out_dtype=out_dtype)
    if groups != 1:
        return qconv_grouped(xq, wq, scale, bias, k=k, stride=stride, pad=pad, groups=groups,
                             **kw)
    if k == 1 and stride == 1 and pad == 0 and xq.shape[1] % 4 == 0:
        return qconv1x1(xq, wq, scale, bias, **kw)
    return qconv_kxk(xq, wq, scale, bias, k=k, stride=stride, pad=pad, **kw)
