"""Shared by the readers of the program's own spans and counters
(``yolort_tpu_torch.utils.profiling``): the events
``yolort_tpu::span.<name>`` and ``yolort_tpu::count.<name>``, which
``trace.parse`` keeps among the dispatcher ops (``Trace.ops``, named
without the ``yolort_tpu::`` prefix; a counter's value is its one
scalar input).

Every function returns None where the trace holds no device event, or no
program span (a program that records none).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

SPAN = "span."
COUNT = "count."
# the spans in which the host launches a batch's device work: an idle gap
# that begins in one of them is the host slower than the card
LAUNCH = frozenset({"letterbox", "network", "postprocess", "cells", "select", "nms", "rescale"})


class Timeline:
    """The innermost program span the host was in, at any host time.
    Program spans are those of the calling thread, so they nest."""

    def __init__(self, spans: List[Tuple[str, int, int]]):
        self._times: List[int] = []
        self._names: List[Optional[str]] = []
        open_: List[Tuple[str, int]] = []
        for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
            self._close(open_, s)
            open_.append((name, e))
            self._mark(s, name)
        self._close(open_, None)

    def _mark(self, t: int, name: Optional[str]) -> None:
        if self._times and self._times[-1] >= t:
            self._names[-1] = name
        else:
            self._times.append(t)
            self._names.append(name)

    def _close(self, open_, t: Optional[int]) -> None:
        """Close the open spans that ended before ``t`` (all where None)."""
        while open_ and (t is None or open_[-1][1] < t):
            end = open_.pop()[1]
            self._mark(end, open_[-1][0] if open_ else None)

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self._times, t) - 1
        return self._names[i] if i >= 0 else None


def spans(run) -> Optional[List[Tuple[str, int, int]]]:
    """The program's spans of the traced run as (name, start, end), or None
    (no device event, no batch, or no ``request`` span)."""
    tr = run.trace
    if tr is None or not tr.device or not run.batches:
        return None
    out = [(o.name[len(SPAN):], o.start, o.end) for o in tr.ops if o.name.startswith(SPAN)]
    return out if any(name == "request" for name, _, _ in out) else None


def timeline(run) -> Optional[Timeline]:
    found = spans(run)
    return None if found is None else Timeline(found)


def host_ms(run, name: str) -> Optional[float]:
    """Host ms a batch inside span ``name``, its children included, over
    the traced window."""
    found = spans(run)
    if found is None:
        return None
    lo, hi = run.trace.window
    ns = sum(e - s for n, s, e in found if n == name and lo <= s and e <= hi)
    return ns / 1e6 / run.batches


def device_ms(run, name: str) -> Optional[float]:
    """Device ms a batch of the work launched while span ``name`` was the
    host's innermost program span, over the traced window."""
    tl = timeline(run)
    if tl is None:
        return None
    lo, hi = run.trace.window
    ns = sum(d.end - d.start for d in run.trace.device
             if d.launch is not None and lo <= d.launch <= hi and tl.at(d.launch) == name)
    return ns / 1e6 / run.batches


def idle_ns(run) -> Optional[Dict[bool, int]]:
    """The traced window's idle device ns, as ``Trace.idle_by_span`` walks
    the gaps, each put down by the program span the host was in when it
    began: {True: in a ``LAUNCH`` span, False: anywhere else (``stack``,
    ``upload``, ``readback``, ``request`` outside its children, between
    calls)}."""
    tl = timeline(run)
    if tl is None:
        return None
    lo, hi = run.trace.window
    out = {True: 0, False: 0}
    prev = lo
    for s, e in run.trace.merged() + [(hi, hi)]:
        if s > prev:
            out[tl.at(prev) in LAUNCH] += s - prev
        prev = max(prev, e)
    return out


def idle_ms(run, launch: bool) -> Optional[float]:
    """Idle device ms a batch whose gap began in a ``LAUNCH`` span
    (``launch``) or elsewhere."""
    ns = idle_ns(run)
    return None if ns is None else ns[launch] / 1e6 / run.batches


def counted(run, name: str) -> Optional[int]:
    """Counter ``name`` summed over the traced window."""
    if spans(run) is None:
        return None
    lo, hi = run.trace.window
    values = [o.scalars[0] for o in run.trace.ops
              if o.name == COUNT + name and lo <= o.start <= hi and o.scalars]
    return int(sum(values)) if values else None


def nms_yield_pct(run) -> Optional[float]:
    """Detections kept over the candidates that entered NMS, in %."""
    kept, cands = counted(run, "kept"), counted(run, "candidates")
    if kept is None or not cands:
        return None
    return 100.0 * kept / cands
