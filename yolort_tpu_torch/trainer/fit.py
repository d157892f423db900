"""The training loop: epochs over a DetectionDataModule with an EMA of the
parameters, metric logging, COCO evaluation, early stopping and per-epoch
checkpoints.

Port of ``yolort_tpu/trainer/fit.py`` on one device (the model's).  The
evaluation serves the network through its postprocess, which on the card
launches the ported kernels; it runs under ``torch.no_grad`` (not
``inference_mode``), so the trained module holds no inference tensors.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from yolort_tpu_torch.data.coco_eval import COCOEvaluator
from yolort_tpu_torch.models._bridge import params_to_jax
from yolort_tpu_torch.models._checkpoint import save_params
from yolort_tpu_torch.models.transform import scale_coords_back
from yolort_tpu_torch.models.yolo import YOLO
from yolort_tpu_torch.trainer.task import DefaultTask, TrainState
from yolort_tpu_torch.trainer.utils import EarlyStopping, ModelEMA
from yolort_tpu_torch.utils.logger import MetricLogger


def _device(model: YOLO) -> torch.device:
    return next(model.parameters()).device


def evaluate(model: YOLO, data_module, canvas_hw) -> Dict[str, float]:
    """COCO-protocol evaluation of ``model`` over a DetectionDataModule."""
    dev = _device(model)
    ev = COCOEvaluator()
    with torch.no_grad():
        for batch in data_module.batches():
            det = model(torch.from_numpy(batch["images"]).to(dev))
            boxes, scores, labels, num = (t.cpu() for t in (det.boxes, det.scores, det.labels,
                                                              det.num))
            preds, tgts = [], []
            for j, raw in enumerate(batch["raw_targets"]):
                n = int(num[j])
                orig = torch.tensor([int(v) for v in raw["orig_size"]], dtype=torch.float32)
                preds.append({"boxes": scale_coords_back(boxes[j][:n], canvas_hw, orig).numpy(),
                              "scores": scores[j][:n].numpy(), "labels": labels[j][:n].numpy()})
                tgts.append({"boxes": raw["boxes"], "labels": raw["labels"]})
            ev.update(preds, tgts)
    ev.synchronize_between_processes()
    return ev.compute()


def fit(
    task: DefaultTask,
    train_data,
    val_data=None,
    *,
    max_epochs: int = 10,
    seed: int = 0,
    use_ema: bool = True,
    patience: Optional[int] = None,
    checkpoint_path: Optional[str] = None,
    print_freq: int = 50,
    state: Optional[TrainState] = None,
) -> TrainState:
    """Train; returns the final TrainState, its model holding the EMA
    parameters when ``use_ema``.  Without ``state`` the model starts from
    ``task.init_state(seed)``.  ``checkpoint_path`` gets the (EMA) params
    after every epoch in the ``save_params`` npz form."""
    state = state or task.init_state(seed)
    dev = _device(state.model)
    # seeded with the pre-training params: the first update blends toward
    # the step-1 params, as the reference's EMA does
    ema = ModelEMA(model=state.model) if use_ema else None
    stopper = EarlyStopping(patience=patience) if patience else None
    logger = MetricLogger()

    for epoch in range(max_epochs):
        for batch in logger.log_every(train_data.batches(), print_freq, header=f"Epoch {epoch}:"):
            bi, bt, bm = (torch.from_numpy(batch[k]).to(dev)
                          for k in ("images", "targets", "target_mask"))
            state, metrics = task.train_step(state, bi, bt, bm)
            logger.update(**{k: float(v) for k, v in metrics.items()})
            if ema is not None:
                ema.update(state.model)

        eval_model = ema.model if ema is not None else state.model
        if val_data is not None:
            results = evaluate(eval_model, val_data, val_data.canvas_hw)
            print(f"Epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in results.items()))
            fitness = 0.1 * results.get("AP50", 0.0) + 0.9 * results.get("AP", 0.0)
            if stopper is not None and stopper(epoch, fitness):
                print(f"early stop at epoch {epoch} (best {stopper.best_fitness:.4f})")
                break

        if checkpoint_path:
            save_params(checkpoint_path, params_to_jax(eval_model), {"epoch": epoch})

    if ema is not None:
        with torch.no_grad():
            for p, e in zip(state.model.parameters(), ema.model.parameters(), strict=True):
                p.copy_(e)
    return state
