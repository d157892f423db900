"""Cross-process collectives for evaluation and logging.

Port of ``yolort_tpu/parallel/distributed.py`` on ``torch.distributed``:
``all_gather_objects`` merges COCO evaluator shards, ``all_reduce_mean``
syncs the logger's meters.  With no initialised process group every
function is the identity of one process, as the JAX package's are at
``jax.process_count() == 1``; with one, the collective is issued, at world
size 1 too.
"""

from __future__ import annotations

from typing import Any, List

import torch
import torch.distributed as dist


def _active() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if _active() else 1


def get_rank() -> int:
    return dist.get_rank() if _active() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def _collective_device() -> torch.device:
    """Where a tensor of a collective lies: the current card under NCCL,
    the CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_objects(obj: Any) -> List[Any]:
    """Every process's picklable ``obj``, in rank order
    (``torch.distributed.all_gather_object``).  No process group:
    ``[obj]``."""
    if not _active():
        return [obj]
    out: List[Any] = [None] * get_world_size()
    dist.all_gather_object(out, obj)
    return out


def all_reduce_mean(value: float) -> float:
    """The mean of a scalar over the processes, in float64.  No process
    group: the value."""
    if not _active():
        return value
    t = torch.tensor([value], dtype=torch.float64, device=_collective_device())
    dist.all_reduce(t)
    return float(t.item()) / get_world_size()
