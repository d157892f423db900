"""Shared by the ``graph_replay`` readers: the program's ``graph_replayed``
counter (``yolort_tpu_torch/utils/graphs.py``), one event a call of the
network, its value 1 where the network's outputs came from a CUDA graph's
replay and 0 where it ran eagerly.

Returns None where the trace holds no device event, no program span, or no
``graph_replayed`` event (a program that replays no graph)."""

from __future__ import annotations

from typing import Optional

from portbench.layers._program import COUNT, spans


def graph_replay_pct(run) -> Optional[float]:
    """Calls of the network that replayed a graph, over all of them, in the
    traced window, in %."""
    if spans(run) is None:
        return None
    lo, hi = run.trace.window
    values = [o.scalars[0] for o in run.trace.ops
              if o.name == COUNT + "graph_replayed" and lo <= o.start <= hi and o.scalars]
    return 100.0 * sum(values) / len(values) if values else None
