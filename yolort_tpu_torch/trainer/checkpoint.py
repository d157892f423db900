"""Train-state checkpoints and optimizer stripping, in the JAX package's
npz layout, so a state saved by either package resumes in the other.

Port of ``yolort_tpu/trainer/checkpoint.py``.  The layout:
  * ``params/<path>``: the JAX params tree (``models._bridge.params_to_jax``);
  * ``opt/<i>``: optax's state leaves in ``jax.tree_util`` order, that is
    the momentum trace over the params tree with every dict's keys sorted
    as strings ("10" before "2"), then the schedule's int32 count when the
    task has ``total_steps``;
  * ``step``; ``__meta__``: JSON bytes.
``train_state_from_jax`` takes the same contents in memory.
"""

from __future__ import annotations

import copy
import json
from typing import Dict, Iterator, Optional, Sequence, Tuple

import numpy as np

from yolort_tpu_torch.models._bridge import params_from_jax, params_to_jax
from yolort_tpu_torch.models._checkpoint import _flatten, save_params
from yolort_tpu_torch.trainer.task import DefaultTask, TrainState


def _sorted_paths(tree: Dict, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, ...]]:
    """Leaf paths of a dict tree in ``jax.tree_util`` order."""
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _sorted_paths(tree[key], prefix + (key,))
        else:
            yield prefix + (key,)


def _get(tree: Dict, path: Tuple[str, ...]):
    for key in path:
        tree = tree[key]
    return tree


def _unflatten(flat: Dict[Tuple[str, ...], np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, v in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = v
    return tree


def save_train_state(path: str, state: TrainState, meta: Optional[dict] = None) -> None:
    """Write the params, the momentum trace, the schedule count and the step."""
    model, opt = state.model, state.optimizer
    flat = {f"params/{k}": v for k, v in _flatten(params_to_jax(model)).items()}
    trace = params_to_jax(model, leaf=lambda p: opt.state[p]["momentum_buffer"])
    leaves = [_get(trace, leaf_path) for leaf_path in _sorted_paths(trace)]
    if state.scheduler is not None:
        leaves.append(np.asarray(state.scheduler.last_epoch, np.int32))
    flat.update({f"opt/{i}": leaf for i, leaf in enumerate(leaves)})
    flat["step"] = np.asarray(int(state.step))
    flat["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), np.uint8)
    np.savez(path, **flat)


def train_state_from_jax(params: Dict, opt_leaves: Sequence[np.ndarray], step: int,
                         task: DefaultTask) -> TrainState:
    """A TrainState of ``task`` from the JAX package's train state as numpy:
    the params tree, optax's state leaves in ``jax.tree_util`` order (the
    momentum trace, then the schedule count when ``task`` has
    ``total_steps``) and the step.  The params go into ``task.model``
    (made trainable), the trace into fresh SGD momentum buffers."""
    model = params_from_jax(params, task.model).trainable()
    paths = list(_sorted_paths(params))
    scheduled = bool(task.total_steps)
    if len(opt_leaves) != len(paths) + scheduled:
        raise ValueError(f"{len(opt_leaves)} optimizer leaves, the task's optimizer has "
                         f"{len(paths) + scheduled}")
    # the trace in the module's own layout: loaded into a copy of the model
    shadow = params_from_jax(_unflatten(dict(zip(paths, opt_leaves))), copy.deepcopy(model))
    opt, sched = task.make_optimizer(int(opt_leaves[-1]) if scheduled else 0)
    for p, buf in zip(model.parameters(), shadow.parameters(), strict=True):
        opt.state[p]["momentum_buffer"] = buf.detach().clone()
    return TrainState(model, opt, sched, int(step))


def load_train_state(path: str, task: DefaultTask) -> Tuple[TrainState, dict]:
    """(TrainState of ``task``, meta) from a ``save_train_state`` file of
    either package (``train_state_from_jax`` on its contents)."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data.files else {}
    params = _unflatten({tuple(k.split("/")[1:]): data[k] for k in data.files
                         if k.startswith("params/")})
    opt = {int(k[len("opt/"):]): data[k] for k in data.files if k.startswith("opt/")}
    leaves = [opt[i] for i in range(len(opt))]
    return train_state_from_jax(params, leaves, int(data["step"]), task), meta


def strip_optimizer(ckpt_path: str, out_path: Optional[str] = None) -> str:
    """Reduce a train-state checkpoint to the params-only ``save_params``
    form (``models._checkpoint.load_params`` of either package reads it)."""
    data = np.load(ckpt_path, allow_pickle=False)
    params = _unflatten({tuple(k.split("/")[1:]): data[k] for k in data.files
                         if k.startswith("params/")})
    meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data.files else {}
    meta["stripped"] = True
    out = out_path or ckpt_path
    save_params(out, params, meta)
    return out
