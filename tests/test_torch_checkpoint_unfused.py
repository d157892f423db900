"""Checkpoint ingestion without folding (``fuse=False``) against the JAX
package, on the CPU, on fabricated ultralytics checkpoints
(``tests/torch_fixture``): r6.0, r3.1, P6 and a custom yaml layout.

- ``load_from_ultralytics(path, version, fuse=False)`` and
  ``load_yaml_from_ultralytics(path, fuse=False)`` give each Conv's
  unfused ``w``, ``gamma``, ``beta``, ``mean`` and ``var``, bit-equal to
  JAX's (both take the fp16 checkpoint's values to float32 the same way).
- The train form built from them (``params_from_jax`` + ``trainable``)
  gives JAX's ``head_outputs`` within atol 1e-4 (tests/test_torch_model.py:
  two frameworks' f32 convolutions about sixty layers deep).
- One SGD step from them matches JAX's at tests/test_torch_train.py's
  tolerances: loss terms rtol 1e-5, params 1e-6 relative to each leaf's
  largest |value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_fixture import make_checkpoint, make_custom_checkpoint
from torch_parity import leaf_errors, random_targets, to_numpy
from yolort_tpu.models import _checkpoint as JC
from yolort_tpu.models import yaml_model as JY
from yolort_tpu.models.yolo import YOLO as JaxYOLO
from yolort_tpu.trainer.task import DefaultTask as JaxTask
from yolort_tpu.trainer.task import TrainState as JaxState
from yolort_tpu_torch.models import _checkpoint as TC
from yolort_tpu_torch.models import yaml_model as TY
from yolort_tpu_torch.models._bridge import params_from_jax, params_to_jax
from yolort_tpu_torch.models.yolo import YOLO
from yolort_tpu_torch.trainer.task import DefaultTask, TrainState

# name: (make_checkpoint keywords, version, nc); the custom layout is the yaml loader's
FAMILIES = {
    "r6.0": (dict(seed=3), "r6.0", 7),
    "r3.1": (dict(seed=12, version="r3.1"), "r3.1", 4),
    "p6": (dict(seed=4, p6=True), "r6.0", 5),
    "custom": (None, None, 7),
}
HW = 64
SGD = dict(lr=0.01, momentum=0.9, weight_decay=5e-4)


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def loaded(request, tmp_path_factory):
    """(name, JAX model, JAX unfused numpy tree, port model from the port's
    unfused leaves, the port's unfused numpy tree)."""
    name = request.param
    make_kw, version, nc = FAMILIES[name]
    path = str(tmp_path_factory.mktemp("unfused") / f"{name}.pt")
    if make_kw is None:
        make_custom_checkpoint(path, nc=nc, seed=5)
        jm, jparams = JY.load_yaml_from_ultralytics(path, fuse=False)
        tm = TY.load_yaml_from_ultralytics(path, fuse=False, device="cpu")
        return name, jm, to_numpy(jparams), tm, params_to_jax(tm)
    make_checkpoint(path, nc=nc, dm=0.33, wm=0.25, **make_kw)
    want = JC.load_from_ultralytics(path, version=version, fuse=False)
    got = TC.load_from_ultralytics(path, version=version, fuse=False)
    for key in ("num_classes", "strides", "anchor_grids", "use_p6", "size"):
        assert got[key] == want[key], key
    arch = dict(version=version, num_classes=got["num_classes"], use_p6=got["use_p6"],
                strides=got["strides"], anchor_grids=got["anchor_grids"])
    jm = JaxYOLO(got["depth_multiple"], got["width_multiple"], **arch)
    tm = params_from_jax(got["params"], YOLO(got["depth_multiple"], got["width_multiple"],
                                             device="cpu", **arch))
    return name, jm, to_numpy(want["params"]), tm, got["params"]


def test_unfused_leaves_are_jax_bit_for_bit(loaded):
    name, _, want, _, got = loaded
    jl, tl = TC._flatten(want), TC._flatten(got)
    assert sorted(jl) == sorted(tl)
    for key, w in jl.items():
        assert tl[key].dtype == w.dtype == np.float32, key
        np.testing.assert_array_equal(tl[key], w, err_msg=key)
    if name == "r6.0":
        assert len(tl) == 291
    # every Conv unfused: its BatchNorm beside its weight and no bias; a
    # bias only on the head's plain Conv2d, one a level
    convs = {k.rsplit("/", 1)[0] for k in tl if k.endswith("/w")}
    with_bn = {c for c in convs if f"{c}/gamma" in tl}
    with_bias = {c for c in convs if f"{c}/b" in tl}
    assert with_bn and not with_bn & with_bias
    assert all({f"{c}/beta", f"{c}/mean", f"{c}/var"} <= set(tl) for c in with_bn)
    assert len(with_bias) == len(loaded[1].strides)


def _batch(nc):
    images = np.random.default_rng(1).random((2, HW, HW, 3)).astype(np.float32)
    return (images, *random_targets(2, nc=nc))


def test_train_form_head_outputs_match_jax(loaded):
    _, jm, want, tm, _ = loaded
    images = _batch(tm.num_classes)[0]
    jout = jax.jit(jm.head_outputs)(jax.tree_util.tree_map(jnp.asarray, want),
                                    jnp.asarray(images))
    tm.trainable()
    tout = tm.head_outputs(torch.from_numpy(images))
    assert len(tout) == len(jout)
    for g, w in zip(tout, jout):
        assert g.requires_grad and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_one_sgd_step_from_the_unfused_leaves_matches_jax(loaded):
    _, jm, want, tm, _ = loaded
    batch = _batch(tm.num_classes)
    jtask = JaxTask(jm, **SGD)
    p0 = jax.tree_util.tree_map(jnp.asarray, want)
    jstate, jmetrics = jax.jit(jtask.train_step)(
        JaxState(p0, jtask.tx.init(p0), jnp.zeros((), jnp.int32)), *map(jnp.asarray, batch))
    task = DefaultTask(tm.trainable(), **SGD)
    state, metrics = task.train_step(TrainState(task.model, *task.make_optimizer()),
                                     *map(torch.from_numpy, batch))
    for key, w in jmetrics.items():
        np.testing.assert_allclose(float(metrics[key]), float(w), rtol=1e-5, err_msg=key)
    errs = leaf_errors(to_numpy(jstate.params), params_to_jax(state.model))
    worst = max(errs)
    assert worst[0] <= 1e-6, worst
