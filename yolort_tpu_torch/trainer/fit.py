"""The training loop: epochs over a DetectionDataModule with an EMA of the
parameters, metric logging, COCO evaluation, early stopping and per-epoch
checkpoints.

Port of ``yolort_tpu/trainer/fit.py``: on the model's device, or over a
``parallel.Mesh`` (one process a device; ``mesh=``), where the train step
is ``data_parallel_train_step`` and the evaluation ``data_parallel_infer``.
The evaluation serves the network through its postprocess, which on the
card launches the ported kernels; it runs under ``torch.no_grad`` (not
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
from yolort_tpu_torch.parallel.distributed import is_main_process
from yolort_tpu_torch.parallel.mesh import data_parallel_infer, data_parallel_train_step, replicate
from yolort_tpu_torch.trainer.task import DefaultTask, TrainState
from yolort_tpu_torch.trainer.utils import EarlyStopping, ModelEMA
from yolort_tpu_torch.utils.logger import MetricLogger


def _device(model: YOLO) -> torch.device:
    return next(model.parameters()).device


def evaluate(model: YOLO, data_module, canvas_hw, mesh=None,
             target_keys=("boxes", "labels")) -> Dict[str, float]:
    """COCO-protocol evaluation of ``model`` over a DetectionDataModule.

    ``mesh`` (a ``parallel.Mesh``): every rank holds the data module's
    batches; rank 0's model is replicated onto the mesh, each batch is
    padded up to a multiple of the data axis (padded rows are never read)
    and served by ``data_parallel_infer``, which gives every rank the
    whole batch's detections.  Rank 0's evaluator takes every image, in
    the data module's order, the others none, and the merge gives each
    rank the same evaluation: COCO AP depends on the images' order where
    scores tie across images.  ``target_keys``: the ground-truth fields
    handed to the evaluator (``tools/eval_metric`` adds the annotations'
    ``iscrowd`` and ``area``; without them every box counts, by its box
    area)."""
    if mesh is not None:
        infer = data_parallel_infer(replicate(mesh, model), mesh)
    dev = _device(model)
    ev = COCOEvaluator()
    with torch.no_grad():
        for batch in data_module.batches():
            images = torch.from_numpy(batch["images"])
            n_img = images.shape[0]
            if mesh is None:
                det = model(images.to(dev))
            else:
                pad = (-n_img) % mesh.data_size
                if pad:
                    images = torch.cat([images, images[:1].expand(pad, *images.shape[1:])])
                det = infer(images)
            rows = range(n_img) if mesh is None or mesh.rank == 0 else range(0)
            boxes, scores, labels, num = (t.cpu() for t in (det.boxes, det.scores, det.labels,
                                                              det.num))
            preds, tgts = [], []
            for j in rows:
                raw = batch["raw_targets"][j]
                n = int(num[j])
                orig = torch.tensor([int(v) for v in raw["orig_size"]], dtype=torch.float32)
                preds.append({"boxes": scale_coords_back(boxes[j][:n], canvas_hw, orig).numpy(),
                              "scores": scores[j][:n].numpy(), "labels": labels[j][:n].numpy()})
                tgts.append({k: raw[k] for k in target_keys})
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
    mesh=None,
) -> TrainState:
    """Train; returns the final TrainState, its model holding the EMA
    parameters when ``use_ema``.  Without ``state`` the model starts from
    ``task.init_state(seed)``.  ``checkpoint_path`` gets the (EMA) params
    after every epoch in the ``save_params`` npz form.

    ``mesh`` (a ``parallel.Mesh``): every rank runs ``fit`` on the same
    data; the state is replicated from rank 0, each step is
    ``data_parallel_train_step`` on the global batch (a batch that does not
    divide the data axis is dropped: padded rows would bias the loss), the
    validation runs ``evaluate(..., mesh=mesh)``.  The ranks' states stay
    equal, and so do their EMAs; rank 0 writes the checkpoints."""
    state = state or task.init_state(seed)
    if mesh is not None:
        state = replicate(mesh, state)
        step_fn = data_parallel_train_step(task, mesh)
    else:
        step_fn = task.train_step
    dev = _device(state.model)
    # seeded with the pre-training params: the first update blends toward
    # the step-1 params, as the reference's EMA does
    ema = ModelEMA(model=state.model) if use_ema else None
    stopper = EarlyStopping(patience=patience) if patience else None
    logger = MetricLogger()

    for epoch in range(max_epochs):
        for batch in logger.log_every(train_data.batches(), print_freq, header=f"Epoch {epoch}:"):
            bi, bt, bm = (torch.from_numpy(batch[k]) for k in ("images", "targets", "target_mask"))
            if mesh is None:
                bi, bt, bm = bi.to(dev), bt.to(dev), bm.to(dev)
            elif bi.shape[0] % mesh.data_size:
                continue
            state, metrics = step_fn(state, bi, bt, bm)
            logger.update(**{k: float(v) for k, v in metrics.items()})
            if ema is not None:
                ema.update(state.model)

        eval_model = ema.model if ema is not None else state.model
        if val_data is not None:
            results = evaluate(eval_model, val_data, val_data.canvas_hw, mesh=mesh)
            print(f"Epoch {epoch}: " + " ".join(f"{k}={v:.4f}" for k, v in results.items()))
            fitness = 0.1 * results.get("AP50", 0.0) + 0.9 * results.get("AP", 0.0)
            if stopper is not None and stopper(epoch, fitness):
                print(f"early stop at epoch {epoch} (best {stopper.best_fitness:.4f})")
                break

        if checkpoint_path and is_main_process():
            save_params(checkpoint_path, params_to_jax(eval_model), {"epoch": epoch})

    if ema is not None:
        with torch.no_grad():
            for p, e in zip(state.model.parameters(), ema.model.parameters(), strict=True):
                p.copy_(e)
    return state
