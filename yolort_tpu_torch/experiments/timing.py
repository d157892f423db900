"""Measurement on the card: CUDA-event and profiler times, the card's name
and power limit, and the least time the card could take for an amount of
work (its bound), by NVIDIA's H100 SXM data sheet."""

from __future__ import annotations

import subprocess
import sys
import time
import warnings

import numpy as np
import torch

# the bound's rates: NVIDIA's H100 SXM data sheet (dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "int8": 1979e12}
PROFILE_ATTEMPTS = 3  # profiler windows taken in search of a complete one
PROFILE_PAD_S = 0.01  # host idle on each side of the recorded calls (see device_profile)
L2_FLUSH_BYTES = 1 << 29  # written before each cold launch: ten times the H100's 50 MB L2


def require_cuda(what: str) -> torch.device:
    """The first CUDA device; raises where torch sees none (a measurement
    never falls back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what} needs a CUDA device; torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, launches: int = 20, repeats: int = 5) -> float:
    """Time of one call on the card: CUDA events around ``launches``
    back-to-back calls, divided by the count; the median of ``repeats``
    such runs, after a warm-up.  Includes any host gaps between launches."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def graph_ms(fn, launches: int = 20, repeats: int = 5) -> float:
    """Device time of one call without host gaps: ``launches`` calls
    captured in one CUDA graph, CUDA events around each replay, divided by
    the count; the median of ``repeats`` replays, after a warm-up.  For
    kernels shorter than their launch on the host, where ``median_ms``
    times the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with torch.cuda.graph(graph):
            for _ in range(launches):
                fn()
    for w in caught:
        if "graph is empty" in str(w.message).lower():
            raise RuntimeError("graph_ms: the capture is empty: fn launches on another stream "
                               "than the current one")
        warnings.warn(w.message, w.category)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    del graph
    return float(np.median(times))


def device_profile(fn, iters: int = 5, kernels_per_call=None):
    """Device time per call from torch.profiler: (total ms, [(kernel name,
    ms), ...] by time), over the device-side records only (kernels, copies,
    memsets; the host-side aten ops that launched them are not summed
    again).  The profiler runs one warm-up step of ``iters`` calls, then
    records the next ``iters`` calls.  The profiler on the H100 machine
    loses device records: windows have held 3 or 4 of 5 launches, and
    some none at all, as if records near a short window's edges fell
    outside it.  So the recorded step is padded with ``PROFILE_PAD_S`` of
    host idle on each side, and a record's time a call is its mean
    duration times its records a call (``per_call``), which a lost record
    does not lower.  Windows are taken until one is complete
    (``window_complete``), at most ``PROFILE_ATTEMPTS``; if none is, the
    one with the most records is read, and if no window saw device time
    this returns (None, []): not measured.  Both cases leave a note on
    stderr.  Raises when windows saw device time but none shows
    ``kernels_per_call`` kernels a call where that is given."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    best, seen = None, []
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for recorded in (False, True):
                if recorded:
                    time.sleep(PROFILE_PAD_S)
                for _ in range(iters):
                    fn()
                torch.cuda.synchronize()
                if recorded:
                    time.sleep(PROFILE_PAD_S)
                prof.step()
        records = {}
        for e in prof.key_averages():
            if "CUDA" not in str(e.device_type) or e.key.startswith("ProfilerStep"):
                continue  # host ops, and the schedule's own step span
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if us > 0:
                records[e.key] = (e.count, us)
        counts = {k: n for k, (n, _) in records.items()}
        seen.append(counts)
        if window_complete(counts, iters, kernels_per_call):
            best = records
            break
        if window_usable(counts, iters, kernels_per_call) and (
                best is None or sum(counts.values()) > sum(n for n, _ in best.values())):
            best = records
    else:
        if best is None and any(seen):
            raise RuntimeError(f"device_profile: no usable window in {PROFILE_ATTEMPTS} (device "
                               f"record counts {seen} over {iters} calls, want {kernels_per_call} "
                               f"kernel(s) a call)")
        read = "not measured" if best is None else "read from the mean record"
        print(f"device_profile: no complete window in {PROFILE_ATTEMPTS} (device record counts "
              f"{seen} over {iters} calls); {read}", file=sys.stderr, flush=True)
        if best is None:
            return None, []
    rows = sorted(per_call(best, iters).items(), key=lambda r: -r[1])
    return sum(ms for _, ms in rows), rows


def records_per_call(count: int, iters: int) -> int:
    """A device record's launches a call, from its count over ``iters``
    calls: the nearest whole number, at least 1 (a record seen at all ran
    in every call of a steady window)."""
    return max(1, round(count / iters))


def per_call(records: dict, iters: int) -> dict:
    """{name: ms a call} from a window's device records {name: (count,
    total us)}: each record's mean duration times its records a call."""
    return {k: us / n * records_per_call(n, iters) / 1e3 for k, (n, us) in records.items()}


def window_complete(counts: dict, iters: int, kernels_per_call=None) -> bool:
    """Whether a profiler window over ``iters`` calls holds every device
    record: ``counts`` ({name: records}) is not empty, each count is a
    multiple of ``iters``, and they sum to ``iters * kernels_per_call``
    where that is given."""
    if not counts or any(n % iters for n in counts.values()):
        return False
    return kernels_per_call is None or sum(counts.values()) == iters * kernels_per_call


def window_usable(counts: dict, iters: int, kernels_per_call=None) -> bool:
    """Whether a window that lost records can still be read by its mean
    record: it saw device time, and its records a call sum to
    ``kernels_per_call`` where that is given."""
    if not counts:
        return False
    return kernels_per_call is None or sum(
        records_per_call(n, iters) for n in counts.values()) == kernels_per_call


def cold_ms(fn, iters: int = 5):
    """Device time of ``fn``'s own work a call with the L2 cache cold, by
    the profiler (``device_profile``): before each call an
    ``L2_FLUSH_BYTES`` buffer is written, so nothing the call reads is
    left in L2 and every line it writes displaces a dirty one, which goes
    back to memory.  The flush's own device records are dropped.  This is
    the time to hold against a bound that moves every byte at the memory
    rate: a warm-L2 time can beat such a bound, which is then no bound.
    None (not measured) where the profiler saw no device time."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    flush_names = {name for name, _ in device_profile(lambda: flush.fill_(1), iters)[1]}
    total, rows = device_profile(lambda: (flush.fill_(1), fn()), iters)
    if not flush_names or total is None:
        return None
    own = [ms for name, ms in rows if name not in flush_names]
    return sum(own) if own else None


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f} ms"


def fmt_share(x) -> str:
    return "not measured" if x is None else f"{100 * x:.1f}%"


def bound(nbytes: float, ops: float = 0.0, kind: str = "f32"):
    """(least ms, 'bytes' | 'operations'): the larger of the bytes moved at
    the memory rate and the operations at the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def same_bits(a, b) -> bool:
    """Equal bit patterns, NaN positions compared as NaN."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return torch.equal(a, b)
    iv = {4: torch.int32, 2: torch.int16}[a.element_size()]
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(a.view(iv)[~nan], b.view(iv)[~nan])


def abs_err(a, b) -> float:
    """Largest |a - b| over the entries where the difference is a number."""
    d = a.double() - b.double()
    d = d[~torch.isnan(d)]
    return float(d.abs().max()) if d.numel() else 0.0


def distinct_rows(phys, m: int) -> int:
    """Distinct (image, row) pairs that clamped row indices (B, k) touch."""
    b = torch.arange(phys.shape[0], device=phys.device)[:, None]
    return int(torch.unique(phys.long().clamp(0, m - 1) + m * b).numel())
