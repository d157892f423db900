"""Optional-dependency gating and version checks.

Port of ``yolort_tpu/utils/dependency.py`` (standard library only)."""

from __future__ import annotations

import functools
import importlib
import warnings
from typing import Callable


@functools.lru_cache(maxsize=None)
def is_module_available(name: str) -> bool:
    try:
        importlib.import_module(name)
        return True
    except ImportError:
        return False


def check_version(current: str, minimum: str) -> bool:
    """Whether version ``current`` >= ``minimum``, compared as (major,
    minor, patch) integers (non-digits dropped, missing parts 0)."""

    def parse(v: str):
        parts = []
        for piece in v.lstrip("v").split(".")[:3]:
            digits = "".join(ch for ch in piece if ch.isdigit())
            parts.append(int(digits or 0))
        while len(parts) < 3:
            parts.append(0)
        return tuple(parts)

    return parse(current) >= parse(minimum)


def requires_module(*modules: str) -> Callable:
    """Decorator: the function raises a clear error when called if any of
    ``modules`` cannot be imported."""

    def deco(fn):
        missing = [m for m in modules if not is_module_available(m)]
        if not missing:
            return fn

        @functools.wraps(fn)
        def stub(*args, **kwargs):
            raise RuntimeError(f"{fn.__name__} requires missing module(s): {', '.join(missing)}")

        return stub

    return deco


def deprecated(reason: str = "") -> Callable:
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            warnings.warn(f"{fn.__name__} is deprecated. {reason}", DeprecationWarning,
                          stacklevel=2)
            return fn(*args, **kwargs)

        return wrapper

    return deco
