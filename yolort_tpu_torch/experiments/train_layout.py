"""The f32 train step's time by the weights' memory format, on the card.

    python -m yolort_tpu_torch.experiments.train_layout [--batch 8] [--runs 4]

yolov5s r6.0 @640 in its train form (``YOLO.init_train(0)``), one seeded
synthetic batch, TF32 off.  Each run builds a fresh model, puts its
weights in one memory format (``contiguous``: NCHW; ``channels_last``:
the layout the serving model holds; the activations are channels_last
either way), takes 3 warm-up steps and times 10 with CUDA events, then
reads a step's device time from the profiler and the part of it spent in
cuDNN's layout conversions (its ``nhwcToNchw`` / ``nchwToNhwc`` kernels).
The runs alternate, contiguous first and last (A B B A for 4), so both
formats meet the same card state.  Every line carries the card's name and
power limit.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from yolort_tpu_torch.experiments.timing import card_line, device_profile, require_cuda
from yolort_tpu_torch.models.yolo import build_yolo
from yolort_tpu_torch.trainer.task import DefaultTask, TrainState

FORMATS = {"contiguous": torch.contiguous_format, "channels_last": torch.channels_last}
LAYOUT_KERNELS = ("nhwcToNchw", "nchwToNhwc")


def synthetic_batch(seed: int, batch: int, device):
    """Images (B, 640, 640, 3) in [0, 1] and 1-4 random boxes an image."""
    rng = np.random.default_rng(seed)
    images = rng.random((batch, 640, 640, 3), dtype=np.float32)
    targets = np.zeros((batch, 4, 5), np.float32)
    targets[..., 0] = rng.integers(0, 80, (batch, 4))
    targets[..., 1:3] = rng.uniform(0.2, 0.8, (batch, 4, 2))
    targets[..., 3:5] = rng.uniform(0.02, 0.4, (batch, 4, 2))
    mask = np.arange(4)[None, :] < rng.integers(1, 5, batch)[:, None]
    return [torch.from_numpy(a).to(device) for a in (images, targets, mask)]


def run(fmt: str, batch_data, steps: int = 10) -> dict:
    device = batch_data[0].device
    task = DefaultTask(build_yolo("yolov5_darknet_pan_s_r60", device=device), lr=0.01,
                       momentum=0.937, weight_decay=5e-4)
    task.model.init_train(0).to(memory_format=FORMATS[fmt])
    state = TrainState(task.model, *task.make_optimizer())
    first = None
    for _ in range(3):
        state, metrics = task.train_step(state, *batch_data)
        first = float(metrics["total"]) if first is None else first
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(steps):
        state, _ = task.train_step(state, *batch_data)
    b.record()
    b.synchronize()
    step_ms = a.elapsed_time(b) / steps
    busy, rows = device_profile(lambda: task.train_step(state, *batch_data), iters=3)
    layout = sum(ms for name, ms in rows if any(k in name for k in LAYOUT_KERNELS))
    return dict(step_ms=step_ms, busy=busy, layout=layout, first=first, rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = require_cuda("train_layout")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    data = synthetic_batch(args.seed, args.batch, device)
    order = ["contiguous", "channels_last", "channels_last", "contiguous"]
    seen = {}
    for i in range(args.runs):
        fmt = order[i % 4]
        r = run(fmt, data)
        seen.setdefault(fmt, []).append(r)
        busy = "not measured" if r["busy"] is None else f"{r['busy']:.2f} ms"
        top = "; ".join(f"{name[:60]} {ms:.3f}" for name, ms in r["rows"][:6])
        print(f"[train_layout] run {i + 1} {fmt:>13}: step {r['step_ms']:.2f} ms (events), "
              f"{args.batch * 1e3 / r['step_ms']:.1f} images/s, device {busy}, layout "
              f"conversions {r['layout']:.3f} ms, first-step total {r['first']:.6f}; top: {top} "
              f"| {card}", flush=True)
    for fmt, rs in seen.items():
        print(f"[train_layout] {fmt}: step ms {[round(r['step_ms'], 2) for r in rs]} | {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
