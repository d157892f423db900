"""Shared by the ``staging_reuse`` readers: the program's ``staged`` and
``staging_grown`` counters (``yolort_tpu_torch/utils/staging.py``).

Returns None where the trace holds no device event, no program span, or no
``staged`` count (a program that stages nothing)."""

from __future__ import annotations

from typing import Optional

from portbench.layers._program import counted


def staging_reuse_pct(run) -> Optional[float]:
    """Uploads through the staging arena that reused it, over all of them,
    in the traced window, in %: 100 x (staged - grown) / staged."""
    staged = counted(run, "staged")
    if not staged:
        return None
    return 100.0 * (staged - (counted(run, "staging_grown") or 0)) / staged
