"""Training utilities: EMA, early stopping, LR schedules.

Port of ``yolort_tpu/trainer/utils.py``: the reference's ModelEMA, with
its decay ramp d = decay * (1 - exp(-updates / tau)), blending every
parameter (the trained BatchNorm ``mean`` and ``var`` too), EarlyStopping,
and the one-cycle schedule as a function of the step, computed in float32
as the JAX schedule computes it.
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch import nn


@dataclass
class ModelEMA:
    """Exponential moving average of a module's parameters, held in a copy
    of the module (``model``; the first ``update`` copies the module when
    none was given)."""

    decay: float = 0.9999
    tau: float = 2000.0
    updates: int = 0
    model: Optional[nn.Module] = None

    def __post_init__(self):
        if self.model is not None:
            self.model = copy.deepcopy(self.model).requires_grad_(False)

    def update(self, model: nn.Module) -> nn.Module:
        self.updates += 1
        d = self.decay * (1 - math.exp(-self.updates / self.tau))
        if self.model is None:
            self.model = copy.deepcopy(model).requires_grad_(False)
            return self.model
        ema = list(self.model.parameters())
        new = [p.detach().to(e.dtype) for e, p in zip(ema, model.parameters(), strict=True)]
        with torch.no_grad():
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, torch._foreach_mul(new, 1.0 - d))
        return self.model


@dataclass
class EarlyStopping:
    """Stop when fitness hasn't improved for ``patience`` epochs."""

    patience: int = 30
    best_fitness: float = 0.0
    best_epoch: int = 0

    def __call__(self, epoch: int, fitness: float) -> bool:
        if fitness >= self.best_fitness:
            self.best_fitness = fitness
            self.best_epoch = epoch
        return (epoch - self.best_epoch) >= self.patience


def one_cycle(y1: float = 0.0, y2: float = 1.0, steps: int = 100) -> Callable[[float], float]:
    """Sinusoidal one-cycle ramp y1 -> y2."""

    def fn(x):
        return ((1 - math.cos(x * math.pi / steps)) / 2) * (y2 - y1) + y1

    return fn


def one_cycle_schedule(base_lr: float, final_lr_frac: float, total_steps: int,
                       warmup_steps: int = 0) -> Callable[[int], float]:
    """step -> LR: linear warmup, then one-cycle cosine decay from base_lr to
    base_lr * final_lr_frac; float32 arithmetic, as the JAX schedule."""
    n = max(total_steps - warmup_steps, 1)

    def schedule(step: int) -> float:
        s = torch.tensor(float(step), dtype=torch.float32)
        warm = base_lr * s / max(warmup_steps, 1)
        x = torch.clamp(s - warmup_steps, min=0)
        decay = base_lr * ((1 - torch.cos(x * math.pi / n)) / 2 * (final_lr_frac - 1.0) + 1.0)
        return float(torch.where(s < warmup_steps, warm, decay))

    return schedule
