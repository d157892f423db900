"""Trained-scene int8 accuracy probe: the PTQ recipe as a harness.

Port of ``yolort_tpu/utils/quant_probe.py``.  An int8 accuracy statement
needs a converged detector: a marginal one turns the noise of per-tensor
activation scales into NMS match flips, which measures tie-breaking, not
quantization.  So:

  1. fabricate 4 one-object scenes with exact ground truth (``make_scenes``),
  2. overfit a nano model to float AP ~1.0 (Adam, cosine decay, 1000
     steps: ``train_scene_detector``),
  3. calibrate, quantize, run ``sensitivity_scan``, skip the worst groups,
  4. report float and int8 AP and the delta (``int8_ap_report``).

Everything runs in full float32: TF32 is off for the cuDNN convs and the
matmuls while the harness trains, calibrates, scans and evaluates (a
reduced-precision float32 changes the scan's ranking).  Entry points run
on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import copy
import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch.optim.lr_scheduler import LambdaLR

SCENE_SIZE = 96
# (x, y, side) of each scene's square object, class 0
SCENE_SPECS = ((32, 24, 48), (8, 8, 48), (40, 40, 48), (16, 44, 48))
LR, LR_ALPHA = 1e-3, 0.05


def make_scenes(size: int = SCENE_SIZE):
    """4 images, each one bright square object (class 0) at its own place;
    returns (images (N, S, S, 3) float32, per-image COCO-style GT)."""
    rng = np.random.default_rng(0)
    images, gts = [], []
    for (x, y, side) in SCENE_SPECS:
        img = rng.uniform(0.2, 0.4, (size, size, 3)).astype(np.float32)
        img[y:y + side, x:x + side] = rng.uniform(0.8, 1.0, (side, side, 3))
        images.append(img)
        gts.append({
            "boxes": np.asarray([[x, y, x + side, y + side]], np.float32),
            "labels": np.asarray([0]),
        })
    return np.stack(images), gts


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms inside the block (cuDNN's included): a run
    of the harness gives the same detector every time, as the JAX
    package's CPU run does; without it the card's atomics make each run's
    outcome a draw."""
    saved = torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0])
        torch.backends.cudnn.deterministic = saved[1]


@contextlib.contextmanager
def full_float32():
    """TF32 off for cuDNN convs and CUDA matmuls inside the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def cosine_lr(count: int, steps: int) -> float:
    """``optax.cosine_decay_schedule(LR, steps, alpha=LR_ALPHA)`` at
    ``count`` (from 0): LR * ((1 - alpha) * 0.5 * (1 + cos(pi * min(count,
    steps) / steps)) + alpha)."""
    t = min(count, steps)
    return LR * ((1.0 - LR_ALPHA) * 0.5 * (1.0 + math.cos(math.pi * t / steps)) + LR_ALPHA)


def scene_optimizer(model, steps: int) -> Tuple[torch.optim.Adam, LambdaLR]:
    """``optax.adam(cosine_decay_schedule(1e-3, steps, alpha=0.05))``:
    Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root) whose step ``t``
    (from 0) takes ``cosine_lr(t, steps)``."""
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    return opt, LambdaLR(opt, lambda c: cosine_lr(c, steps) / LR)


def _device(model) -> torch.device:
    return next(t.device for t in (*model.parameters(), *model.buffers()))


def scene_model(device=None):
    """The scene detector: yolov5n r6.0, 2 classes, score_thresh 0.1,
    pre_nms_topk 256, on ``device`` (default the card)."""
    from yolort_tpu_torch.models.yolo import build_yolo

    return build_yolo("yolov5_darknet_pan_n_r60", device="cuda" if device is None else device,
                      num_classes=2, score_thresh=0.1, pre_nms_topk=256)


def scene_targets(gts, size: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(targets (B, 4, 5), mask (B, 4)) of the scenes' GT, normalised cxcywh."""
    from yolort_tpu_torch.models.losses import pad_targets

    per_image = [
        {"labels": g["labels"],
         "boxes_cxcywh_norm": np.asarray(
             [[(b[0] + b[2]) / 2 / size, (b[1] + b[3]) / 2 / size,
               (b[2] - b[0]) / size, (b[3] - b[1]) / size] for b in g["boxes"]])}
        for g in gts
    ]
    return pad_targets(per_image, 4, device)


def train_scenes(model, images, gts, steps: int = 1000) -> float:
    """``steps`` Adam steps of ``DefaultTask.loss_fn`` on the whole scene
    batch, in full float32 with deterministic algorithms, on the model's
    device; the model must be trainable.  Returns the last total loss."""
    from yolort_tpu_torch.trainer.task import DefaultTask

    device = _device(model)
    imgs = torch.as_tensor(np.asarray(images), device=device)
    targets, mask = scene_targets(gts, imgs.shape[1], device)
    task = DefaultTask(model)
    opt, sched = scene_optimizer(model, steps)
    total = torch.zeros(())
    with full_float32(), deterministic():
        for _ in range(steps):
            opt.zero_grad(set_to_none=True)
            total, _ = task.loss_fn(imgs, targets, mask)
            total.backward()
            opt.step()
            sched.step()
    total = float(total.detach())
    if not math.isfinite(total):
        raise RuntimeError("scene training diverged")
    return total


# the init draw of the scene detector.  Whether 1000 steps converge
# depends on the draw, in the JAX package too (its PRNGKey(0)..(5) reach
# float AP 1.0, 1.0, 1.0, 0.67, 0.77, 0.18 on the CPU); 2 is the first
# seed of the port's generator that converged in every run measured, on
# the CPU and on the card (PERF.md section 6 lists the runs)
SCENE_SEED = 2


def train_scene_detector(images, gts, steps: int = 1000, device=None):
    """Overfit the scene detector from ``init_train(SCENE_SEED)``; returns
    the model, frozen.  Adam with a cosine decay from 1e-3 reaches float AP
    1.0 in about 1000 steps from a draw in the converging basin, where the
    reference's SGD(0.05) plateaus near 0.34."""
    model = scene_model(device).init_train(SCENE_SEED)
    train_scenes(model, images, gts, steps)
    return model.requires_grad_(False)


def eval_ap(model, images, gts) -> float:
    """COCO AP of ``model``'s detections on the scenes against their exact
    GT (the postprocess kernels on the card)."""
    from yolort_tpu_torch.data.coco_eval import COCOEvaluator

    with torch.inference_mode(), full_float32():
        det = model(torch.as_tensor(np.asarray(images), device=_device(model)))
    boxes, scores, labels, num = (t.cpu().numpy() for t in (det.boxes, det.scores, det.labels,
                                                             det.num))
    ev = COCOEvaluator()
    ev.update([{"boxes": boxes[i][: num[i]], "scores": scores[i][: num[i]],
                "labels": labels[i][: num[i]]} for i in range(len(num))], gts)
    return float(ev.compute()["AP"])


def int8_ap_report(model, images, gts, target_delta: float = 0.05,
                   max_skip: int = 4) -> Dict[str, float]:
    """The PTQ accuracy recipe, iterative as the reference's ppq flow:
    calibrate on the scenes, quantize all, verify AP, then extend the skip
    list with the sensitivity scan's next-worst group until ``float_ap -
    int8_ap <= target_delta`` (or ``max_skip`` groups are out; the delta
    reported is then the best reached).  The quantized models run with
    runtime scales (no ``finalize_scales``), as JAX's do.  ``model`` is
    left as it is.

    Keys: ``float_ap``, ``int8_ap_all`` (no skip list), ``int8_ap`` /
    ``delta`` / ``skip`` (the accepted configuration), ``n_skip``."""
    from yolort_tpu_torch.ops.quantization import (
        calibrate_activations, quantize_compute_params, sensitivity_scan,
    )

    imgs = torch.as_tensor(np.asarray(images), device=_device(model))
    float_ap = eval_ap(model, images, gts)
    cal = calibrate_activations(copy.deepcopy(model), [imgs])
    int8_all = eval_ap(quantize_compute_params(cal), images, gts)
    with full_float32():
        ranked = sensitivity_scan(lambda m, x: m.decode(x), cal, imgs)

    best_ap, best_skip = int8_all, ()
    for n_skip in range(1, min(max_skip, len(ranked)) + 1):
        if float_ap - best_ap <= target_delta:
            break
        skip = tuple(g for g, _ in ranked[:n_skip])
        ap = eval_ap(quantize_compute_params(cal, skip=skip), images, gts)
        if ap > best_ap:
            best_ap, best_skip = ap, skip
    return {
        "float_ap": round(float_ap, 4),
        "int8_ap_all": round(int8_all, 4),
        "int8_ap": round(best_ap, 4),
        "delta": round(float_ap - best_ap, 4),
        "skip": ",".join(best_skip),
        "n_skip": len(best_skip),
    }
