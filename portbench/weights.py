"""The weights both sides get, made from the seed on the device.

1. Every convolution's weight (and the head convolutions' bias) is drawn
   U(-1, 1) / sqrt(fan_in), PyTorch's default initialisation, in one call
   of a device generator seeded from the seed; the head's class biases
   get per-(anchor, class) noise N(0, ``class_bias_noise``), so a random
   stack scores classes apart.
2. BatchNorm: gamma U(0.2, 0.6) (``GAMMA``) and beta N(0, 0.1), as the
   port's test fixture draws beta.  Then, where the network has them,
   every ``nn.Linear``'s weight and bias and every
   ``nn.MultiheadAttention``'s own projections are drawn U(-1, 1) /
   sqrt(fan_in) in one more call (a network without them draws nothing
   more); a floating-point parameter that no draw reaches is an error.
   The running mean and variance are the statistics
   of the activations on the cell's first frames (one forward with the
   statistics taken from the batch), so every layer's output is O(1) and
   depends on the frame.  The fixture's random statistics leave the
   head's logits nearly constant over the image (their spread across
   positions is below 1e-3 at yolov5s's width), and a check could then
   not tell one anchor's detection from another's.
3. Every leaf is rounded to float16, as ultralytics ships checkpoints.
4. The objectness and class biases are shifted by the candidate-density
   calibration (``reference.arith.candidate_shift``) on the reference's
   logits of every frame of the cell's pool, and rounded to float16
   again.

The reference keeps the float16 values in float32; the program loads the
same values from an ultralytics checkpoint (``reference.models.save_checkpoint``).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
from torch import nn

from portbench.reference import models, pipeline
from portbench.reference.arith import candidate_shift

# BatchNorm gamma's range: with the test fixture's U(0.5, 1.5) and the
# statistics of the frames, the random network is chaotic (a float16
# rounding of each activation grows to 2-4% of the head's logits, and the
# program's bfloat16 path to 10-30% of their spread, where a trained
# network's stays near the rounding); U(0.2, 0.6) keeps it near 0.3%.
GAMMA = (0.2, 0.6)


def _fill_uniform(leaves: Sequence[torch.Tensor], fan_ins: Sequence[int], gen: torch.Generator) -> None:
    sizes = [t.numel() for t in leaves]
    dev = leaves[0].device
    flat = torch.rand(sum(sizes), generator=gen, device=dev) * 2.0 - 1.0
    scale = torch.repeat_interleave(
        torch.tensor([fi ** -0.5 for fi in fan_ins], device=dev),
        torch.tensor(sizes, device=dev))
    flat *= scale
    for t, part in zip(leaves, flat.split(sizes)):
        t.copy_(part.view_as(t))


def _dense_leaves(net: nn.Module) -> Tuple[List[torch.Tensor], List[int]]:
    """Every ``nn.Linear``'s weight and bias, and every
    ``nn.MultiheadAttention``'s own parameters (``in_proj_weight`` and
    ``in_proj_bias``, or the separate q/k/v weights; ``out_proj`` is a
    Linear), with their fan-in."""
    leaves, fans = [], []
    for m in net.modules():
        if isinstance(m, nn.Linear):
            own = [(m.weight, m.in_features)] + ([] if m.bias is None else [(m.bias, m.in_features)])
        elif isinstance(m, nn.MultiheadAttention):
            own = [(p, p.shape[1] if p.dim() == 2 else m.embed_dim)
                   for p in m.parameters(recurse=False)]
        else:
            continue
        for t, fan in own:
            leaves.append(t)
            fans.append(fan)
    return leaves, fans


@torch.no_grad()
def make(net: nn.Module, seed: int, stat_frames: torch.Tensor, pool_frames, cfg: dict,
         fixed=None, head_logits: Callable = models.head_logits) -> float:
    """Fill ``net`` (on its device, float32) in place from ``seed``.
    ``stat_frames``: (B, 3, H, W) canvases for the BatchNorm statistics;
    ``pool_frames``: every uint8 HWC frame of the cell, for the
    calibration; ``head_logits``: the reference module's.  Returns the
    bias shift applied."""
    dev = next(net.parameters()).device
    convs = [m for m in net.modules() if isinstance(m, nn.Conv2d)]
    leaves = [c.weight for c in convs] + [c.bias for c in convs if c.bias is not None]
    fans = [c.weight[0].numel() for c in convs] + [c.weight[0].numel() for c in convs
                                                  if c.bias is not None]
    bns = [m for m in net.modules() if isinstance(m, nn.BatchNorm2d)]
    dense, dense_fans = _dense_leaves(net)
    drawn = {id(t) for t in leaves + dense} | {id(t) for b in bns for t in (b.weight, b.bias)}
    missed = [n for n, t in net.named_parameters() if t.is_floating_point() and id(t) not in drawn]
    if missed:
        raise ValueError(f"no draw reaches the parameters {missed}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2 ** 63))
    _fill_uniform(leaves, fans, gen)
    det = next(m for m in net.modules() if isinstance(m, models.FDetect))
    noise = torch.randn(len(det.m), det.na, det.nc, generator=gen, device=dev)
    noise *= float(cfg["assumed"]["class_bias_noise"])
    for conv, nz in zip(det.m, noise):
        conv.bias.view(det.na, det.no)[:, 5:] += nz
    n = sum(b.num_features for b in bns)
    gamma = torch.rand(n, generator=gen, device=dev) * (GAMMA[1] - GAMMA[0]) + GAMMA[0]
    beta = torch.randn(n, generator=gen, device=dev) * 0.1
    for b, g, be in zip(bns, gamma.split([b.num_features for b in bns]),
                        beta.split([b.num_features for b in bns])):
        b.weight.copy_(g)
        b.bias.copy_(be)
        b.momentum = 1.0
    if dense:
        _fill_uniform(dense, dense_fans, gen)
    net.train()
    head_logits(net, stat_frames)
    net.eval()
    for b in bns:
        b.momentum = 0.1
    for t in list(net.parameters()) + list(net.buffers()):
        if t.is_floating_point():
            t.copy_(t.half().float())
    logits = []
    for s in range(0, len(pool_frames), 8):
        chunk = pool_frames[s:s + 8]
        plans = [pipeline.plan(tuple(f.shape[:2]), tuple(cfg["size"]), int(cfg["size_divisible"]),
                               fixed) for f in chunk]
        for canvas in sorted({p.canvas for p in plans}):
            x = torch.stack([pipeline.letterbox(f, p) for f, p in zip(chunk, plans) if p.canvas == canvas])
            lv = head_logits(net, x)
            logits.append(torch.cat([t.reshape(t.shape[0], -1, t.shape[-1]) for t in lv], 1))
    shift = candidate_shift(logits, target=int(cfg["assumed"]["candidates_above_0.25"]))
    for conv in det.m:
        b = conv.bias.view(det.na, det.no)
        b[:, 4:] += shift
        conv.bias.copy_(conv.bias.half().float())
    return shift
