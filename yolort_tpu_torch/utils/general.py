"""General small utilities: stride rounding, seeds, colored strings,
numbered run directories.

Port of ``yolort_tpu/utils/general.py`` (standard library and numpy);
``one_cycle`` is the port's ``trainer.utils.one_cycle``."""

from __future__ import annotations

import math
import random
from pathlib import Path
from typing import Sequence, Union

from yolort_tpu_torch.trainer.utils import one_cycle  # noqa: F401


def make_divisible(x: float, divisor: int) -> int:
    return int(math.ceil(x / divisor) * divisor)


def check_img_size(imgsz: Union[int, Sequence[int]], s: int = 32, floor: int = 0):
    """Image size(s) rounded up to a multiple of the model stride ``s``."""
    if isinstance(imgsz, int):
        return max(make_divisible(imgsz, s), floor)
    return [max(make_divisible(v, s), floor) for v in imgsz]


def init_seeds(seed: int = 0) -> None:
    """Seed Python's and numpy's global generators."""
    import numpy as np

    random.seed(seed)
    np.random.seed(seed)


_COLORS = {
    "black": "\033[30m", "red": "\033[31m", "green": "\033[32m",
    "yellow": "\033[33m", "blue": "\033[34m", "magenta": "\033[35m",
    "cyan": "\033[36m", "white": "\033[37m", "bright_red": "\033[91m",
    "bright_green": "\033[92m", "bright_yellow": "\033[93m",
    "bright_blue": "\033[94m", "bold": "\033[1m", "underline": "\033[4m",
    "end": "\033[0m",
}


def colorstr(*inputs):
    """colorstr('blue', 'bold', 'hello') -> the ANSI-colored string (blue
    bold where only the string is given)."""
    *styles, string = inputs if len(inputs) > 1 else ("blue", "bold", inputs[0])
    return "".join(_COLORS.get(s, "") for s in styles) + str(string) + _COLORS["end"]


def increment_path(path: str, exist_ok: bool = False, sep: str = "", mkdir: bool = False) -> Path:
    """runs/exp -> runs/exp2, runs/exp3, ...: the first free numbered path
    (``path`` itself where it is free or ``exist_ok``)."""
    p = Path(path)
    if p.exists() and not exist_ok:
        suffix = p.suffix
        stem = p.with_suffix("")
        for n in range(2, 10000):
            cand = Path(f"{stem}{sep}{n}{suffix}")
            if not cand.exists():
                p = cand
                break
    if mkdir:
        (p if not p.suffix else p.parent).mkdir(parents=True, exist_ok=True)
    return p
