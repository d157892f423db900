"""Pinned-shape streaming inference pipeline.

Port of ``yolort_tpu/runtime/streaming.py``: batch-N uint8 frames of one
fixed size, normalise + letterbox + network + postprocess on the model's
device, the host-to-device copy of the next batch overlapped with the
compute of the current one, one batch in flight.

On the card the host fills one of two pinned uint8 staging buffers in
place (``np.copyto``, no stacked array), a side stream copies it to the
device (``non_blocking``) and records an event the compute stream waits
on, and the detections come back into pinned buffers with
``non_blocking`` copies and an event.  A staging buffer is refilled only
after the copy out of it has finished (its event), and the uploaded batch
is marked as used by the compute stream (``record_stream``) so that the
allocator does not hand its memory out while the network reads it.  On
the CPU the frames go to the model as they are.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Tuple

import numpy as np
import torch
from torch import nn

from yolort_tpu_torch.runtime.aot import _pipeline_fn, model_device, plan_for


class StreamingPipeline:
    """Serves uint8 HWC frames of size ``input_hw`` in batches of
    ``batch_size`` on ``model``'s device, the model taken in ``dtype``."""

    def __init__(
        self,
        model: nn.Module,
        *,
        batch_size: int = 32,
        input_hw: Tuple[int, int] = (640, 640),
        dtype: torch.dtype = torch.bfloat16,
    ):
        self.batch_size = batch_size
        self.input_hw = (int(input_hw[0]), int(input_hw[1]))
        plan = plan_for(self.input_hw)
        self.canvas_hw = plan.canvas_hw
        self.device = model_device(model)
        self._fn = _pipeline_fn(model, plan, dtype)
        if self.device.type == "cuda":
            shape = (batch_size, *self.input_hw, 3)
            self._staging = [torch.empty(shape, dtype=torch.uint8, pin_memory=True)
                             for _ in range(2)]
            self._copied: List = [None, None]  # each staging buffer's last copy's event
            self._copy_stream = torch.cuda.Stream(self.device)
            self._out: List[torch.Tensor] = []  # pinned detections of the batch in flight
            self._slot = 0

    def warmup(self, iters: int = 2) -> None:
        dummy = np.zeros((*self.input_hw, 3), np.uint8)
        for _ in range(iters):
            for _ in self.run([dummy] * self.batch_size):
                pass

    def _batches(self, frames: Iterable[np.ndarray]) -> Iterator[Tuple[List[np.ndarray], int]]:
        """Lists of ``batch_size`` frames and the number of real ones: the
        tail is padded with its last frame."""
        buf: List[np.ndarray] = []
        for f in frames:
            f = np.asarray(f, np.uint8)
            if f.shape != (*self.input_hw, 3):
                raise ValueError(f"frame of shape {f.shape}, the pipeline takes "
                                 f"{(*self.input_hw, 3)}")
            buf.append(f)
            if len(buf) == self.batch_size:
                yield buf, self.batch_size
                buf = []
        if buf:
            n = len(buf)
            yield buf + [buf[-1]] * (self.batch_size - n), n

    def _upload(self, batch: List[np.ndarray]) -> torch.Tensor:
        """The batch on the device: on the card through a pinned staging
        buffer and the copy stream (the compute stream waits on the copy);
        on the CPU as it is."""
        if self.device.type != "cuda":
            return torch.from_numpy(np.stack(batch))
        slot = self._slot
        self._slot ^= 1
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # the copy out of this buffer is done
        host = self._staging[slot].numpy()
        for i, f in enumerate(batch):
            np.copyto(host[i], f)
        with torch.cuda.stream(self._copy_stream):
            dev = self._staging[slot].to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        self._copied[slot] = copied
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(copied)
        dev.record_stream(compute)
        return dev

    def _dispatch(self, staged: torch.Tensor):
        """Launch the pipeline on a staged batch; on the card its detections
        are copied into the pinned output buffers behind an event."""
        with torch.no_grad():
            outs = self._fn(staged)
        if self.device.type != "cuda":
            return outs, None
        if not self._out:
            self._out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in outs]
        for host, t in zip(self._out, outs):
            host.copy_(t, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return self._out, done

    def run(self, frames: Iterable[np.ndarray]) -> Iterator[Dict[str, np.ndarray]]:
        """Stream uint8 HWC frames (of ``input_hw``); yields each frame's
        detection dict (canvas coordinates).  Keeps one batch in flight:
        batch i+1 is staged and its copy started while the device computes
        batch i."""
        pending = None  # (outputs, event, n_valid)
        for batch, n in self._batches(frames):
            staged = self._upload(batch)
            if pending is not None:
                yield from self._drain(*pending)
            pending = (*self._dispatch(staged), n)
        if pending is not None:
            yield from self._drain(*pending)

    @staticmethod
    def _drain(outs, done, n_valid: int) -> Iterator[Dict[str, np.ndarray]]:
        if done is not None:
            done.synchronize()
        boxes, scores, labels, num = (t.numpy() for t in outs)
        for i in range(n_valid):
            n = int(num[i])
            # copies: the pinned buffers take the next batch's detections
            yield {"boxes": boxes[i, :n].astype(np.float32),
                   "scores": scores[i, :n].astype(np.float32),
                   "labels": labels[i, :n].astype(np.int64)}
