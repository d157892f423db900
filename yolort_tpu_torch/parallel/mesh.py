"""Data-parallel serving and training over processes, one device each.

Port of ``yolort_tpu/parallel/mesh.py`` on ``torch.distributed``.  The JAX
package shards a batch over a mesh's ``data`` axis inside one jitted
program; here each process drives one device (NCCL on the card, gloo on
the CPU), holds the whole global batch, takes its own rows of it, and the
collectives put the results together:

  * ``data_parallel_infer``: every rank's padded ``Detections`` all-gathered
    in rank order, so each rank gets the whole batch's, as JAX's
    ``out_shardings=batch_sharding`` gives it;
  * ``data_parallel_train_step``: the step of the global batch.  The loss
    normalises its box and class terms by the candidate count of the whole
    batch, so the per-level counts are summed over the ranks before the
    loss divides by them, each rank's objectness mean is divided by the
    number of shards, and the gradients are summed: the result is the
    single-process step on the global batch (up to summation order), as
    XLA's global loss is.

The collectives are issued whenever the mesh's process group is up, at
world size 1 too (where they cost microseconds), so one card runs the
same NCCL calls as many.

A ``model`` axis larger than 1 only replicates, as in the JAX package:
the ranks of one model group take the same rows, and the gradients are
summed over the ranks of one data group.  There is no tensor parallelism.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from yolort_tpu_torch.models.yolo import resolve_device
from yolort_tpu_torch.ops.nms import Detections


@dataclass(frozen=True)
class Mesh:
    """This process's place in a (data, model) grid of ranks: rank r is
    data index r // model_size and model index r % model_size, as the JAX
    mesh reshapes its device list.  ``data_group`` holds the ranks of this
    rank's model index (None: every rank)."""

    device: torch.device
    rank: int
    world_size: int
    data_size: int
    model_size: int
    data_group: Any = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.model_size

    @property
    def model_rank(self) -> int:
        return self.rank % self.model_size

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed in place over the data group; returns it."""
        dist.all_reduce(t, group=self.data_group)
        return t

    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The data group's ``t`` concatenated on the first axis, in rank
        order."""
        src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.data_size)]
        dist.all_gather(parts, src, group=self.data_group)
        out = torch.cat(parts)
        return out.bool() if t.dtype == torch.bool else out


def make_mesh(devices: Optional[Sequence] = None, model_axis: int = 1, *,
              init_method: Optional[str] = None, world_size: Optional[int] = None,
              rank: Optional[int] = None) -> Mesh:
    """The (data, model) mesh of this process.

    ``devices`` lists each rank's device (default: card ``rank % count``,
    which raises where torch sees no card); the backend is NCCL for a card
    and gloo for the CPU.  A process group already initialised is used as
    it is (its backend must be that one).  Otherwise one is initialised
    with ``init_method`` (``tcp://localhost:<port>``, ``file://...``),
    ``world_size`` and ``rank``; at world size 1 with no ``init_method`` a
    ``HashStore`` of this process serves as the rendezvous."""
    if dist.is_initialized():
        if world_size is not None or rank is not None or init_method is not None:
            raise ValueError("a process group is up: pass no init_method, world_size or rank")
        world_size, rank = dist.get_world_size(), dist.get_rank()
    else:
        world_size = 1 if world_size is None else world_size
        rank = 0 if rank is None else rank
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 1
        device = resolve_device(f"cuda:{rank % n}")
    else:
        if len(devices) != world_size:
            raise ValueError(f"{len(devices)} devices for {world_size} ranks")
        device = resolve_device(devices[rank])
    if device.type == "cuda":
        device = torch.device("cuda", device.index or 0)
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}, {device} needs "
                             f"{backend}")
    elif init_method is None:
        if world_size != 1:
            raise ValueError("more than one rank needs an init_method")
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    else:
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank)
    if world_size % model_axis:
        raise ValueError(f"{world_size} ranks not divisible by model axis {model_axis}")
    data_size = world_size // model_axis
    data_group = None
    if model_axis > 1:
        # every rank creates every group, in the same order
        for j in range(model_axis):
            g = dist.new_group([j + model_axis * d for d in range(data_size)])
            if rank % model_axis == j:
                data_group = g
    return Mesh(device, rank, world_size, data_size, model_axis, data_group)


def _broadcast(tensors) -> None:
    for t in tensors:
        # NCCL takes contiguous tensors only: a channels_last weight on the
        # card goes through a contiguous copy
        buf = t.detach().contiguous()
        dist.broadcast(buf, src=0)
        if buf.data_ptr() != t.data_ptr():
            t.detach().copy_(buf)


def replicate(mesh: Mesh, tree):
    """Rank 0's parameters and buffers on every rank, on the mesh's device:
    of a module, or of a ``TrainState`` (its model and its optimizer's
    momentum buffers).  In place; returns ``tree``."""
    from yolort_tpu_torch.trainer.task import TrainState

    model = tree.model if isinstance(tree, TrainState) else tree
    if not isinstance(model, nn.Module):
        raise TypeError(f"replicate takes a module or a TrainState, got {type(tree).__name__}")
    model.to(mesh.device)  # parameters keep their identity: the optimizer still holds them
    tensors = [*model.parameters(), *model.buffers()]
    if isinstance(tree, TrainState):
        for p in model.parameters():
            st = tree.optimizer.state.get(p, {})
            if st.get("momentum_buffer") is not None:
                st["momentum_buffer"] = st["momentum_buffer"].to(mesh.device)
                tensors.append(st["momentum_buffer"])
    _broadcast(tensors)
    return tree


def shard_batch(mesh: Mesh, tree):
    """This rank's rows of a global batch that every rank holds (a tensor,
    a numpy array, or a tuple, list or dict of them), as tensors on the
    mesh's device.  The batch must divide the data-axis size."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(shard_batch(mesh, v) for v in tree)
    t = torch.from_numpy(np.ascontiguousarray(tree)) if isinstance(tree, np.ndarray) else tree
    b = t.shape[0]
    if b % mesh.data_size:
        raise ValueError(f"batch of {b} does not divide the data axis of {mesh.data_size}")
    n = b // mesh.data_size
    return t[mesh.data_rank * n:(mesh.data_rank + 1) * n].to(mesh.device)


def data_parallel_infer(model: nn.Module, mesh: Mesh):
    """A callable from a global batch of letterboxed images (every rank
    holds it; its size divides the data axis) to the whole batch's padded
    ``Detections``: each rank runs ``model`` on its rows, and the rows are
    all-gathered in rank order.  This is the batch-sharded inference the
    reference refuses (its tools/eval_metric.py:109)."""

    def infer(images) -> Detections:
        with torch.no_grad():
            det = model(shard_batch(mesh, images))
        return Detections(*(mesh.gather_rows(t) for t in det))

    return infer


def data_parallel_train_step(task, mesh: Mesh):
    """A train step ``(state, images, targets, target_mask) -> (state,
    metrics)`` over the mesh: each argument the global batch, which every
    rank holds; each rank steps on its rows, the candidate counts and
    gradients summed over the data axis (``DefaultTask.train_step``'s
    ``data_axis``).  The state and the metrics are those of the
    single-process step on the global batch."""

    def step(state, images, targets, target_mask):
        return task.train_step(state, *shard_batch(mesh, (images, targets, target_mask)),
                               data_axis=mesh)

    return step
