"""Training/eval metric logging.

Port of ``yolort_tpu/utils/logger.py``: windowed meters and an ETA-aware
iteration logger; wandb streaming stays optional and soft-gated.
``synchronize_between_processes`` averages each meter's total over the
processes (``parallel.distributed.all_reduce_mean``).
"""

from __future__ import annotations

import datetime
import time
import importlib.util
from collections import defaultdict, deque
from typing import Dict, Iterable

from yolort_tpu_torch.parallel.distributed import all_reduce_mean


class SmoothedValue:
    """Track a series with a smoothing window and global totals."""

    def __init__(self, window_size: int = 20, fmt: str = "{median:.4f} ({global_avg:.4f})"):
        self.deque = deque(maxlen=window_size)
        self.total = 0.0
        self.count = 0
        self.fmt = fmt

    def update(self, value: float, n: int = 1):
        self.deque.append(value)
        self.count += n
        self.total += value * n

    def synchronize_between_processes(self):
        self.total = all_reduce_mean(self.total)

    @property
    def median(self) -> float:
        d = sorted(self.deque)
        return d[len(d) // 2] if d else 0.0

    @property
    def avg(self) -> float:
        return sum(self.deque) / max(len(self.deque), 1)

    @property
    def global_avg(self) -> float:
        return self.total / max(self.count, 1)

    @property
    def value(self) -> float:
        return self.deque[-1] if self.deque else 0.0

    def __str__(self):
        return self.fmt.format(
            median=self.median, avg=self.avg, global_avg=self.global_avg, value=self.value
        )


class MetricLogger:
    def __init__(self, delimiter: str = "  ", use_wandb: bool = False, **wandb_init):
        self.meters: Dict[str, SmoothedValue] = defaultdict(SmoothedValue)
        self.delimiter = delimiter
        self.wandb = None
        if use_wandb and importlib.util.find_spec("wandb") is not None:
            import wandb

            self.wandb = wandb
            wandb.init(**wandb_init)

    def update(self, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v))
        if self.wandb is not None:
            self.wandb.log({k: float(v) for k, v in kwargs.items()})

    def __getattr__(self, name):
        if name in self.meters:
            return self.meters[name]
        raise AttributeError(name)

    def __str__(self):
        return self.delimiter.join(f"{k}: {m}" for k, m in self.meters.items())

    def synchronize_between_processes(self):
        for m in self.meters.values():
            m.synchronize_between_processes()

    def log_every(self, iterable: Iterable, print_freq: int, header: str = ""):
        i = 0
        start = time.time()
        iter_time = SmoothedValue(fmt="{avg:.4f}")
        try:
            total = len(iterable)  # type: ignore[arg-type]
        except TypeError:
            total = None
        end = time.time()
        for obj in iterable:
            yield obj
            iter_time.update(time.time() - end)
            if i % print_freq == 0:
                if total:
                    eta = datetime.timedelta(seconds=int(iter_time.global_avg * (total - i)))
                    print(f"{header} [{i}/{total}] eta: {eta} {self} time: {iter_time}")
                else:
                    print(f"{header} [{i}] {self} time: {iter_time}")
            i += 1
            end = time.time()
        elapsed = datetime.timedelta(seconds=int(time.time() - start))
        print(f"{header} Total time: {elapsed}")
