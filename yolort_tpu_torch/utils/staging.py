"""A request's host arrays sent to the device in one copy, through one
reused host buffer (page-locked on a card).

``StagingArena.stage`` writes the parts of a request (arrays, or lists of
same-shaped arrays to stack) one after another into the buffer, each at an
offset aligned to ``ALIGN`` bytes; ``upload`` sends the bytes in use to
the device in one copy (asynchronous from pinned memory) and gives each
part back as a view of that copy, in its shape and dtype.  The buffer is
allocated on the first ``stage`` and again only when a request needs more
bytes than it holds, so it grows to the largest request seen.  It is
written again only once the copy out of it has finished: the copy records
an event, and ``stage`` waits for it where it has not completed.  Hold
``lock`` from ``stage`` through ``upload`` where threads share an arena.

Counters (``utils.profiling.count``, recorded only under the profiler):
``staged``, 1 a part list uploaded, and ``staging_grown``, 1 an
allocation of the buffer.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from yolort_tpu_torch.utils import profiling

ALIGN = 64  # each part's byte offset: float32 parts 4-byte aligned, frames on a cache line

Part = Union[np.ndarray, Sequence[np.ndarray]]


def part_spec(part: Part) -> Tuple[Tuple[int, ...], np.dtype]:
    """(shape, dtype) of a part: an array as it is, a list of arrays stacked
    on a new first axis."""
    if isinstance(part, np.ndarray):
        return part.shape, part.dtype
    return (len(part), *part[0].shape), part[0].dtype


def layout(specs: Sequence[Tuple[Tuple[int, ...], np.dtype]]) -> Tuple[List[int], int]:
    """The byte offset of each (shape, dtype) placed one after another, each
    rounded up to ``ALIGN``, and the bytes they take in all."""
    offsets, end = [], 0
    for shape, dtype in specs:
        end = -(-end // ALIGN) * ALIGN
        offsets.append(end)
        end += int(np.prod(shape, dtype=np.int64)) * np.dtype(dtype).itemsize
    return offsets, end


class StagingArena:
    """One host buffer a request's parts are written into and uploaded from;
    page-locked where ``pinned`` (a CUDA device's upload), plain otherwise."""

    def __init__(self, pinned: bool = True):
        self.pinned = pinned
        self.lock = threading.Lock()
        self._host: Optional[torch.Tensor] = None  # uint8, the buffer
        self._copied = None  # the event recorded after the last copy out of it
        self._staged: List[Tuple[int, int, Tuple[int, ...], torch.dtype]] = []  # off, bytes
        self._used = 0

    def stage(self, parts: Sequence[Part]) -> None:
        """Write ``parts`` into the buffer (``layout`` of their specs), once
        the last copy out of it has finished; a buffer too small for them is
        replaced by one of their size."""
        specs = [part_spec(p) for p in parts]
        offsets, total = layout(specs)
        if self._copied is not None and not self._copied.query():
            self._copied.synchronize()
        if self._host is None or self._host.numel() < total:
            self._host = torch.empty(total, dtype=torch.uint8, pin_memory=self.pinned)
            profiling.count("staging_grown", 1)
        buf = self._host.numpy()
        self._staged = []
        for part, off, (shape, dtype) in zip(parts, offsets, specs):
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            view = buf[off:off + n].view(dtype).reshape(shape)
            if isinstance(part, np.ndarray):
                np.copyto(view, part)
            else:
                np.stack(part, out=view)
            self._staged.append((off, n, shape, torch.from_numpy(np.empty(0, dtype)).dtype))
        self._used = total

    def upload(self, device) -> List[torch.Tensor]:
        """The staged parts on ``device``, each a view of one copy of the
        buffer's bytes in use (asynchronous from pinned memory, on the
        device's current stream, followed by an event)."""
        dev = torch.empty(self._used, dtype=torch.uint8, device=device)
        dev.copy_(self._host[:self._used], non_blocking=True)
        if dev.is_cuda:
            if self._copied is None:
                self._copied = torch.cuda.Event()
            self._copied.record(torch.cuda.current_stream(dev.device))
        profiling.count("staged", 1)
        return [dev[off:off + n].view(dtype).view(shape) for off, n, shape, dtype in self._staged]
