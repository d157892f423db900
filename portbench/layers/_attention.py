"""Shared by the ``attention_*`` readers: the program's ``attention`` span
and ``attention_tokens`` counter (``TransformerBlock.forward``,
``yolort_tpu_torch/ops/blocks.py``).

Every function returns None where the trace holds no device event, no
program span, or no ``attention`` span (a network without a
``TransformerBlock``, or a program that records none)."""

from __future__ import annotations

from typing import Optional

from portbench.bounds import _attention
from portbench.layers._device import per_batch_ms
from portbench.layers._program import counted, device_ms, spans


def attention_ms(run) -> Optional[float]:
    """Device ms a batch of the work launched while ``attention`` was the
    host's innermost program span."""
    found = spans(run)
    if found is None or not any(name == "attention" for name, _, _ in found):
        return None
    return device_ms(run, "attention")


def attention_share_pct(run) -> Optional[float]:
    """That time over the device time of the work launched inside the
    benchmark's ``portbench.network`` span (the network and its children),
    in %."""
    part, whole = attention_ms(run), per_batch_ms(run, "portbench.network")
    if part is None or not whole:
        return None
    return 100.0 * part / whole


def attention_roofline_pct(run) -> Optional[float]:
    """The block's least time over the window (``bounds/_attention.py``,
    from ``attention_tokens``, at the card's peaks) over its device time,
    in %."""
    ms, tokens = attention_ms(run), counted(run, "attention_tokens")
    if not ms or not tokens:
        return None
    cfg = run.cell.config
    (ch, cw) = run.canvas
    nbytes, ops = _attention.work(tokens, run.batches, (ch // 32) * (cw // 32),
                                  _attention.block_width(cfg), _attention.layers(cfg),
                                  4 if cfg["dtype"] == "float32" else 2)
    least = run.bounds.least_seconds(nbytes, ops, cfg["dtype"])
    return 100.0 * least / (ms * run.batches / 1e3)
