"""The float convs' epilogue: ``bias_act`` (``csrc/bias_act.cu``), with its
plain PyTorch version, and the float activations it applies.

Replaces no TPU kernel: XLA fuses a conv's bias and activation into the
conv.  Under cuDNN, ATen runs a float conv without its bias, then adds the
bias in a pass of its own (``output.add_(bias)``: on a ``channels_last``
output its per-element kernel, which cannot coalesce the broadcast), and
the activation is one more pass.  The kernel does both in one read and one
write of the conv's output, in place:

    y[n, c, h, w] = act(y[n, c, h, w] + bias[c])

computed in float32 and rounded to y's dtype wherever ATen's ops round
(after the add, after each operation of the activation), so that it is
``ACTS[act](y + bias)`` bit for bit in every dtype and a network's outputs
are the same with it as without.  ``ops/blocks.py`` decides which convs
take it (``fused_epilogue``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from yolort_tpu_torch.ops.cuda import _build
from yolort_tpu_torch.ops.cuda.qconv_kernel import ACTS as ACT_CODES

# the dtypes the kernel stores, and their codes in csrc/bias_act.cu
KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def hardswish(x: torch.Tensor) -> torch.Tensor:
    """x * relu6(x + 3) / 6, written as the JAX package computes it."""
    return x * torch.clamp(x + 3.0, 0.0, 6.0) * (1.0 / 6.0)


def leaky_relu01(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.1 * x)


def relu(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x)


# the convs' activations by name (``Conv.act``), each the plain version of
# the kernel's own code for it (``ACT_CODES``, csrc/act.cuh)
ACTS = {"silu": silu, "hardswish": hardswish, "leaky_relu": leaky_relu01, "relu": relu,
        "none": lambda x: x}


def bias_act_reference(y: torch.Tensor, bias: torch.Tensor, act: str) -> torch.Tensor:
    """Plain version: ``ACTS[act](y + bias over channels)`` in y's dtype, a
    new tensor in y's memory format: the ops ATen runs after a biased conv."""
    return ACTS[act](y + bias.view(1, -1, 1, 1))


def bias_act_(y: torch.Tensor, bias: torch.Tensor, act: str) -> torch.Tensor:
    """The kernel on y in place, unchecked: y a CUDA tensor of a dtype in
    ``KINDS``, contiguous in ``channels_last``, ``bias`` (C,) contiguous on
    its device in its dtype, ``act`` a key of ``ACTS``.  One launch on the
    current stream; returns y.  The float convs call it where
    ``blocks.fused_epilogue`` holds; any other caller, ``bias_act``."""
    _build.launch(bias_act, "yt_bias_act", y, y.data_ptr(), bias.data_ptr(), y.numel(),
                  y.shape[1], ACT_CODES[act], KINDS[y.dtype])
    return y


def bias_act(y: torch.Tensor, bias: torch.Tensor, act: str) -> torch.Tensor:
    """y (N, C, H, W) <- act(y + bias[c]) in place, bit for bit
    ``bias_act_reference`` (float32, bfloat16 or float16); returns y.
    On the card y must be contiguous in ``channels_last`` and the kernel
    runs; on the CPU any layout takes ``bias_act_reference``."""
    if y.dim() != 4 or y.dtype not in KINDS:
        raise ValueError(f"bias_act: y must be (N, C, H, W) float32, bfloat16 or float16, got "
                         f"{tuple(y.shape)} {y.dtype}")
    if bias.shape != (y.shape[1],) or bias.dtype != y.dtype or bias.device != y.device:
        raise ValueError(f"bias_act: bias must be ({y.shape[1]},) {y.dtype} on {y.device}, got "
                         f"{tuple(bias.shape)} {bias.dtype} on {bias.device}")
    if act not in ACTS:
        raise ValueError(f"bias_act: act must be one of {sorted(ACTS)}, got {act!r}")
    if y.device.type == "cpu":
        return y.copy_(bias_act_reference(y, bias, act))
    if y.device.type != "cuda":
        raise ValueError(f"bias_act runs on cuda or cpu tensors, not {y.device}")
    if not y.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bias_act needs y contiguous in channels_last memory (NHWC)")
    return bias_act_(y, bias.contiguous(), act)


bias_act.launches = 0
