"""Profiling and tracing helpers: a profiler trace, the request path's
spans and counters, a synchronised clock, device memory statistics, the
model summary, and the candidate load that makes a random-weight
network's postprocess do a real network's work.

Port of ``yolort_tpu/utils/profiling.py`` on ``torch.profiler`` and
``torch.utils.flop_counter``.  ``calibrate_candidate_density`` and
``shift_head_bias`` are the port's counterpart of the bench's candidate
calibration (``bench.calibrate_candidate_density``), shared by
``tools/profile_stages.py`` and ``chip_smoke.py``.

Spans and counters (``span``, ``count``, ``count_later``) record only
while ``torch.profiler`` records: each is a ``cpu_op`` event named
``yolort_tpu::span.<name>`` or ``yolort_tpu::count.<name>`` on the
profiler's clock, a counter's value its event's one input (seen with
``record_shapes=True``, as ``trace`` records).  With the profiler off a
span is one flag read and a shared no-op context.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_PREFIX = "yolort_tpu::span."
COUNT_PREFIX = "yolort_tpu::count."
_OFF = contextlib.nullcontext()
_held = threading.local()  # .counts: the counts kept on the device in this thread's request


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the ``with`` block on the host and, where torch sees a card,
    on the card (``torch.profiler``, with the inputs' shapes and the
    counters' values); on exit the Chrome trace is written to
    ``log_dir/trace.json`` (Perfetto, chrome://tracing).  Yields the
    profiler (``key_averages()`` sums the records by name)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, record_shapes=True) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def recording() -> bool:
    """True while ``torch.profiler`` records in this process and no compiler
    (``torch.export``, ``torch.compile``) is tracing the code."""
    return _autograd_profiler._is_profiler_enabled and not torch.compiler.is_compiling()


def span(name: str):
    """The context of span ``yolort_tpu::span.<name>`` while the profiler
    records; else one shared no-op context.  A ``cpu_op`` event, never a
    user annotation: the profiler copies those onto the device's timeline."""
    if not recording():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)


def count(name: str, value: int) -> None:
    """A zero-length event ``yolort_tpu::count.<name>`` whose one input is
    ``value``, while the profiler records."""
    if recording():
        with torch._C._profiler._RecordFunctionFast(COUNT_PREFIX + name, [int(value)]):
            pass


@contextlib.contextmanager
def _request(seq: int):
    outer = getattr(_held, "counts", None)
    _held.counts = []
    try:
        with torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + "request", [int(seq)]):
            yield
    finally:
        _held.counts = outer


def request(seq: int):
    """Span ``request`` of one call (``seq`` its sequence number), which
    holds the counts ``count_later`` keeps until ``emit_held_counts``;
    a no-op context while the profiler is off."""
    return _request(seq) if recording() else _OFF


def count_later(name: str, tensor: torch.Tensor) -> None:
    """Keep ``tensor`` (a mask or counts, on its device), whose sum is count
    ``name`` of the current ``request``, for ``emit_held_counts``: nothing
    is launched or waited for inside the launch path.  Nothing outside a
    request or with the profiler off."""
    held = getattr(_held, "counts", None)
    if held is not None and recording():
        held.append((name, tensor))


def emit_held_counts() -> None:
    """Sum the tensors the current request keeps and read the sums in one
    copy to the host (call it once the device's results are read, so it
    waits for nothing), then emit each as ``count``."""
    held = getattr(_held, "counts", None)
    if not held:
        return
    values = torch.stack([t.sum(dtype=torch.int64) for _, t in held]).cpu().tolist()
    for (name, _), value in zip(held, values):
        count(name, value)
    held.clear()


def time_sync(device=None) -> float:
    """``time.perf_counter()`` after the work queued on ``device`` has
    finished: a CUDA device is synchronised (that device only); on the CPU
    the clock is read at once."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """{device: {statistic: bytes}} of every CUDA device torch sees, from
    ``torch.cuda.memory_stats`` (the keys that count bytes); empty where
    there is none."""
    out = {}
    for i in range(torch.cuda.device_count() if torch.cuda.is_available() else 0):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {k: int(v) for k, v in stats.items()
                            if isinstance(v, (int, float)) and "bytes" in k}
    return out


def forward_flops(model, size: int = 640) -> int:
    """The floating-point operations of ``model.head_outputs`` on one
    ``size`` x ``size`` image, counted by ``FlopCounterMode`` (a
    multiply-add is 2; convolutions and matmuls only, no elementwise
    ops).  The forward runs once, on the model's device and dtype."""
    from torch.utils.flop_counter import FlopCounterMode

    first = next(model.parameters())
    x = torch.zeros((1, size, size, 3), dtype=first.dtype, device=first.device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model.head_outputs(x)
    return int(counter.get_total_flops())


def model_info(model) -> str:
    """Summary string: the parameter count and the forward FLOPs at 640
    (``forward_flops``)."""
    from yolort_tpu_torch.utils.common import count_params

    lines = [f"params: {count_params(model) / 1e6:.2f}M"]
    lines.append(f"forward FLOPs @640: {forward_flops(model, 640) / 1e9:.1f} G")
    return ", ".join(lines)


def calibrate_candidate_density(m, requests, target: int = 120, margin: float = 0.5) -> float:
    """Head-bias shift that gives every image at least ``target`` pairs with
    score > 0.25: seeded random weights keep scores near 1e-4, which would
    leave the selection and NMS kernels with no work.  Bisects the shift
    on ``YOLOv5`` ``m``'s own logits of the requests' frames (lists of HWC
    uint8 arrays of one size), as the bench's calibration does, then adds
    ``margin``: random weights make the count a cliff in the shift, and the
    margin keeps a bias rounded to bfloat16 on the busy side of it."""
    yolo = m.model
    logits = []
    for raw_u8 in requests:
        x = torch.from_numpy(np.stack(raw_u8)).to(m.device)
        with torch.inference_mode():
            outs = yolo.head_outputs(m.canvas(x)[0])
        logits.append(torch.cat([o.reshape(o.shape[0], -1, 5 + yolo.num_classes).float()
                                 for o in outs], dim=1))

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


def shift_head_bias(yolo, delta: float) -> None:
    """Add ``delta`` to the objectness and class biases of ``yolo``'s head
    (in place)."""
    with torch.no_grad():
        for conv in yolo.head.children():
            conv.bias.view(yolo.num_anchors, -1)[:, 4:] += delta
