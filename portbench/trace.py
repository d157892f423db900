"""The traced run's timeline, from ``torch.profiler``'s own records.

``parse`` keeps, for the traced window:

* ``spans``: the benchmark's ``record_function`` spans on the host
  (``portbench.request``, ``.letterbox``, ``.network``, ``.postprocess``);
* ``device``: every kernel, copy and fill on the card, with the host time
  of the call that launched it (the runtime event of the same
  correlation id), so it can be charged to the span the host was in;
* ``ops``: every ``yolort_tpu::*`` dispatcher op, with its input shapes
  (``record_shapes``) and the device time of what it launched.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

OP_PREFIX = "yolort_tpu::"


@dataclass
class DeviceEvent:
    name: str
    kind: str
    start: int
    end: int
    launch: Optional[int]  # host ns of the launching call; None where it was not recorded


@dataclass
class OpEvent:
    name: str
    start: int
    end: int
    shapes: list
    dtypes: list
    scalars: list
    device_ns: int = 0


@dataclass
class Trace:
    window: Tuple[int, int]
    spans: List[Tuple[str, int, int]]
    device: List[DeviceEvent]
    ops: List[OpEvent]
    _layer_starts: List[int] = field(default_factory=list, repr=False)
    _layers: List[Tuple[str, int, int]] = field(default_factory=list, repr=False)
    _req_starts: List[int] = field(default_factory=list, repr=False)
    _reqs: List[Tuple[str, int, int]] = field(default_factory=list, repr=False)

    def __post_init__(self):
        from portbench.program import REQUEST_SPAN

        self._layers = sorted((s for s in self.spans if s[0] != REQUEST_SPAN), key=lambda s: s[1])
        self._reqs = sorted((s for s in self.spans if s[0] == REQUEST_SPAN), key=lambda s: s[1])
        self._layer_starts = [s[1] for s in self._layers]
        self._req_starts = [s[1] for s in self._reqs]

    @staticmethod
    def _find(starts, spans, t) -> Optional[str]:
        i = bisect.bisect_right(starts, t) - 1
        return spans[i][0] if i >= 0 and spans[i][2] >= t else None

    def span_at(self, t: Optional[int]) -> Optional[str]:
        """The innermost benchmark span the host was in at host time ``t``."""
        if t is None:
            return None
        return self._find(self._layer_starts, self._layers, t) or self._find(
            self._req_starts, self._reqs, t)

    def busy_ns(self) -> int:
        return sum(e - s for s, e in self.merged())

    def merged(self) -> List[Tuple[int, int]]:
        """The union of device activity inside the window, as intervals."""
        lo, hi = self.window
        ivs = sorted((max(e.start, lo), min(e.end, hi)) for e in self.device
                     if e.end > lo and e.start < hi)
        out: List[List[int]] = []
        for s, e in ivs:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def idle_by_span(self) -> Dict[str, int]:
        """Idle device ns inside the window, by the span the host was in
        when each gap began."""
        lo, hi = self.window
        out: Dict[str, int] = {}
        prev = lo
        for s, e in self.merged() + [(hi, hi)]:
            if s > prev:
                name = self.span_at(prev) or "outside calls"
                out[name] = out.get(name, 0) + (s - prev)
            prev = max(prev, e)
        return out


def _is_launch(name: str) -> bool:
    """A CUDA API call (cudaLaunchKernel, cuLaunchKernelEx, cudaMemcpyAsync, ...) that starts
    device work."""
    return name.startswith("cuda") or (name.startswith("cu") and name[2:3].isupper())


def _device_kind(name: str) -> str:
    low = name.lower()
    return "memcpy" if low.startswith("memcpy") else "memset" if low.startswith("memset") else "kernel"


def parse(prof) -> Trace:
    """``prof``: a finished ``torch.profiler.profile`` around the window.
    The traced window runs from the first request span's start to the
    last one's end, on the profiler's clock (ns)."""
    from torch.autograd import DeviceType

    from portbench.program import REQUEST_SPAN, SPAN_PREFIX

    events = prof.profiler.kineto_results.events()
    launches: Dict[int, int] = {}
    spans, device_raw, ops = [], [], []
    for ev in events:
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            if not name.startswith(SPAN_PREFIX):  # the spans' own device-side annotations
                device_raw.append(ev)
        elif name.startswith(SPAN_PREFIX):
            spans.append((name, ev.start_ns(), ev.start_ns() + ev.duration_ns()))
        elif name.startswith(OP_PREFIX):
            shapes = ev.structured_input_shapes() if hasattr(ev, "structured_input_shapes") else ev.shapes()
            ops.append(OpEvent(name[len(OP_PREFIX):], ev.start_ns(), ev.start_ns() + ev.duration_ns(),
                               list(shapes), list(ev.dtypes()), list(ev.concrete_inputs())))
        elif _is_launch(name):
            launches[ev.correlation_id()] = ev.start_ns()
    device = []
    for ev in device_raw:
        launch = launches.get(ev.correlation_id())
        if launch is None:
            launch = launches.get(ev.linked_correlation_id())
        device.append(DeviceEvent(ev.name(), _device_kind(ev.name()), ev.start_ns(),
                                  ev.start_ns() + ev.duration_ns(), launch))
    reqs = [s for s in spans if s[0] == REQUEST_SPAN]
    if not reqs:
        raise ValueError("the trace holds no request span")
    window = (min(s[1] for s in reqs), max(s[2] for s in reqs))
    ops.sort(key=lambda o: o.start)
    starts = [o.start for o in ops]
    for d in device:
        if d.launch is None:
            continue
        i = bisect.bisect_right(starts, d.launch) - 1
        if i >= 0 and ops[i].end >= d.launch:
            ops[i].device_ns += d.end - d.start
    return Trace(window, spans, device, ops)
