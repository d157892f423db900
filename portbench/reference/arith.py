"""Arithmetic the benchmark copies so that the program cannot move it:
the candidate-density calibration and the forward FLOP count.

``candidate_shift`` is the bisection of
``yolort_tpu_torch/utils/profiling.py`` ``calibrate_candidate_density``
(at e28db24), run on the reference network's logits: the shift of the
objectness and class biases that gives every frame at least ``target``
pairs scoring above 0.25, plus ``margin``.  ``forward_flops`` is that
module's ``forward_flops``: ``FlopCounterMode`` over one forward, a
multiply-add counted as 2, convolutions and matmuls only.
"""

from __future__ import annotations

from typing import Sequence

import torch


def candidate_shift(logits: Sequence[torch.Tensor], target: int = 120,
                    margin: float = 0.5) -> float:
    """``logits``: chunks of (B, N, 5 + nc) raw head logits, every anchor
    of every level.  Random weights make the count a cliff in the shift;
    the margin keeps a bias rounded to a lower precision on the busy side
    of it."""

    def count_at(d):
        counts = []
        for lg in logits:
            s = torch.sigmoid(lg[..., 4:5] + d) * torch.sigmoid(lg[..., 5:] + d)
            counts.append(int((s > 0.25).sum(dim=(1, 2)).min()))
        return min(counts)

    lo, hi = 0.0, 20.0
    for _ in range(30):
        mid = (lo + hi) / 2
        if count_at(mid) < target:
            lo = mid
        else:
            hi = mid
    return hi + margin


def forward_flops(fn, x: torch.Tensor) -> int:
    """Floating-point operations of ``fn(x)``, counted by
    ``FlopCounterMode`` (a multiply-add is 2)."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(x)
    return int(counter.get_total_flops())
