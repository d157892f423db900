"""Training task: loss, optimizer and one train step.

Port of ``yolort_tpu/trainer/task.py``.  The JAX task holds a model spec
and steps a pure ``TrainState(params, opt_state, step)``; here the model
module holds the parameters, ``torch.optim.SGD`` the momentum trace and a
``LambdaLR`` the schedule's count, and ``train_step`` updates them in
place.

The update is optax's ``chain(add_decayed_weights(wd), sgd(lr, momentum))``:
d = g + wd * p, trace = momentum * trace + d, p -= lr * trace, on every
parameter (each gets a gradient tensor, so none misses its decay).  The
trace starts at zero, as optax's does.  With ``total_steps`` the LR of step
``count`` (from 0) is ``one_cycle_schedule(count)``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
from torch.optim.lr_scheduler import LambdaLR

from yolort_tpu_torch.models.losses import YOLOLoss
from yolort_tpu_torch.models.yolo import YOLO
from yolort_tpu_torch.trainer.utils import one_cycle_schedule


@dataclass
class TrainState:
    """``model`` holds the params, ``optimizer`` the momentum trace,
    ``scheduler`` (None at a constant LR) the schedule count as its
    ``last_epoch``; ``step`` counts train steps."""

    model: YOLO
    optimizer: torch.optim.SGD
    scheduler: Optional[LambdaLR]
    step: int = 0


@dataclass
class DefaultTask:
    """A model, its loss and its optimizer.

    With ``total_steps`` set, the LR follows linear warmup then one-cycle
    cosine decay to ``lr * final_lr_frac``.  A ``hyp`` dict
    (``trainer.hyp.DEFAULT_HYP`` schema) sets lr0 / lrf / momentum /
    weight_decay and every loss gain."""

    model: YOLO
    lr: float = 0.01
    momentum: float = 0.9
    weight_decay: float = 5e-4
    total_steps: Optional[int] = None
    warmup_steps: int = 0
    final_lr_frac: float = 0.1
    hyp: Optional[Dict] = None
    loss: YOLOLoss = field(init=False)

    def __post_init__(self):
        loss_kw = {}
        if self.hyp is not None:
            h = self.hyp
            self.lr = float(h.get("lr0", self.lr))
            self.momentum = float(h.get("momentum", self.momentum))
            self.weight_decay = float(h.get("weight_decay", self.weight_decay))
            self.final_lr_frac = float(h.get("lrf", self.final_lr_frac))
            loss_kw = dict(
                box_gain=float(h.get("box", 0.05)),
                cls_gain=float(h.get("cls", 0.5)),
                obj_gain=float(h.get("obj", 1.0)),
                cls_pos=float(h.get("cls_pw", 1.0)),
                obj_pos=float(h.get("obj_pw", 1.0)),
                anchor_thresh=float(h.get("anchor_t", 4.0)),
                fl_gamma=float(h.get("fl_gamma", 0.0)),
                label_smoothing=float(h.get("label_smoothing", 0.0)),
            )
        self.loss = YOLOLoss(strides=self.model.strides, anchor_grids=self.model.anchor_grids,
                             num_classes=self.model.num_classes, **loss_kw)

    def schedule(self, count: int) -> float:
        """The LR of the step whose schedule count is ``count``."""
        if not self.total_steps:
            return self.lr
        return one_cycle_schedule(self.lr, self.final_lr_frac, self.total_steps,
                                  self.warmup_steps)(count)

    def make_optimizer(self, count: int = 0) -> Tuple[torch.optim.SGD, Optional[LambdaLR]]:
        """SGD over the model's parameters with zero momentum buffers, and
        the schedule at ``count`` (None at a constant LR)."""
        params = list(self.model.parameters())
        opt = torch.optim.SGD(params, lr=self.lr, momentum=self.momentum,
                              weight_decay=self.weight_decay, dampening=0, nesterov=False)
        for p in params:
            opt.state[p]["momentum_buffer"] = torch.zeros_like(p)
        if not self.total_steps:
            return opt, None
        for g in opt.param_groups:
            g["initial_lr"] = self.lr
        return opt, LambdaLR(opt, lambda c: self.schedule(c) / self.lr, last_epoch=count - 1)

    def init_state(self, seed: int = 0) -> TrainState:
        """The model in its train form from ``seed`` (``YOLO.init_train``),
        a fresh optimizer, step 0."""
        self.model.init_train(seed)
        return TrainState(self.model, *self.make_optimizer())

    def loss_fn(self, images: torch.Tensor, targets: torch.Tensor, target_mask: torch.Tensor,
                data_axis=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        outs = self.model.head_outputs(images)
        losses = self.loss(outs, targets, target_mask, data_axis=data_axis)
        total = losses["cls_logits"] + losses["bbox_regression"] + losses["objectness"]
        return total, losses

    def train_step(self, state: TrainState, images: torch.Tensor, targets: torch.Tensor,
                   target_mask: torch.Tensor, data_axis=None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One SGD step. images (B, H, W, 3) letterboxed; targets (B, T, 5)
        [cls, cxcywh normalised] padded per image; target_mask (B, T).
        Returns the state and the detached loss terms and total.

        ``data_axis`` (a ``parallel.Mesh``): the batch is this rank's shard
        of a global batch (``parallel.data_parallel_train_step``); the loss
        takes the global candidate counts, and the gradients and the
        returned terms are summed over the data axis, so that every rank
        takes the global batch's step."""
        opt = state.optimizer
        opt.zero_grad(set_to_none=True)
        total, losses = self.loss_fn(images, targets, target_mask, data_axis)
        total.backward()
        params = [p for group in opt.param_groups for p in group["params"]]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if data_axis is not None:
            _sum_gradients(params, data_axis)
        opt.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total"] = total.detach()
        if data_axis is not None:
            keys = list(metrics)
            summed = data_axis.all_sum(torch.stack([metrics[k] for k in keys]))
            metrics = dict(zip(keys, summed.unbind()))
        return state, metrics


def _sum_gradients(params, data_axis) -> None:
    """Sum every gradient over the data axis: one flat buffer a dtype."""
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        by_dtype.setdefault(p.grad.dtype, []).append(p)
    for group in by_dtype.values():
        flat = data_axis.all_sum(torch.cat([p.grad.reshape(-1) for p in group]))
        offset = 0
        for p in group:
            n = p.grad.numel()
            p.grad.copy_(flat[offset:offset + n].view_as(p.grad))
            offset += n
