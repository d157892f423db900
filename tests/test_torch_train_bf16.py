"""bfloat16 training of the port against the JAX package's, on the CPU:
the params cast to bfloat16 (``utils.common.cast_floating``), the optimizer
initialised again on the cast params, bfloat16 images, as the JAX
package's ``bench.py`` ``run_train`` does.  Tiny model (depth 0.33, width
0.125, 8 classes), 64x64, batch 2, one and three SGD steps (constant LR
and the scheduled one of tests/test_torch_train.py).

The loss gathers its candidates in the head's dtype and casts them to
float32, as JAX's does; the momentum buffers are bfloat16, as optax's
trace follows the cast tree.  Tolerances, measured on these inputs: loss
terms rtol 5e-4 (worst 1.5e-4: two frameworks' bfloat16 convolutions
round their float32 sums at different points; a bfloat16 ulp is 3.9e-3
relative), params 2e-3 relative to each leaf's largest |value| (worst
3.2e-5 at the constant LR, 7.2e-4 at step 3 of the scheduled one, a bias
leaf: most updates are a few bfloat16 ulps of their leaf), the momentum
trace 1e-1 (worst 4.3e-2, a fused conv's bias: its gradient is a
bfloat16 sum over every output position, rounded differently by the two
frameworks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import DEPTH, WIDTH, leaf_errors, random_targets, randomize_convs, to_numpy
from yolort_tpu.models.yolo import YOLO as JaxYOLO
from yolort_tpu.trainer.task import DefaultTask as JaxTask
from yolort_tpu.trainer.task import TrainState as JaxState
from yolort_tpu.utils import cast_floating as jax_cast_floating
from yolort_tpu.utils import count_params as jax_count_params
from yolort_tpu_torch.models._bridge import params_from_jax, params_to_jax
from yolort_tpu_torch.models.yolo import YOLO
from yolort_tpu_torch.trainer.task import DefaultTask, TrainState
from yolort_tpu_torch.utils.common import cast_floating, count_params

NC = 8
CONFIGS = {
    "constant": dict(lr=0.01, momentum=0.9, weight_decay=5e-4),
    "scheduled": dict(lr=0.02, momentum=0.937, weight_decay=5e-4, total_steps=6, warmup_steps=2,
                      final_lr_frac=0.2),
}
STEPS = 3
TOL = {"loss": 5e-4, "param": 2e-3, "trace": 1e-1}


def _batch(seed: int):
    images = np.random.default_rng(seed).random((2, 64, 64, 3)).astype(np.float32)
    targets, mask = random_targets(seed, nc=NC)
    return images, targets, mask


def _f32(tree):
    return to_numpy(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), tree))


@pytest.fixture(scope="module")
def params():
    return randomize_convs(JaxYOLO(DEPTH, WIDTH, num_classes=NC).init(jax.random.PRNGKey(0)), 0)


@pytest.fixture(scope="module")
def jax_runs(params):
    jm = JaxYOLO(DEPTH, WIDTH, num_classes=NC)
    runs = {}
    for name, cfg in CONFIGS.items():
        task = JaxTask(jm, **cfg)
        step = jax.jit(task.train_step)
        p = jax_cast_floating(jax.tree_util.tree_map(jnp.asarray, params), jnp.bfloat16)
        state = JaxState(p, task.tx.init(p), jnp.zeros((), jnp.int32))
        states, metrics = [], []
        for i in range(STEPS):
            images, targets, mask = _batch(i)
            state, m = step(state, jnp.asarray(images, jnp.bfloat16), jnp.asarray(targets),
                            jnp.asarray(mask))
            states.append(state)
            metrics.append({k: float(v) for k, v in m.items()})
        runs[name] = (states, metrics)
    return runs


def _port_state(params, cfg):
    model = params_from_jax(params, YOLO(DEPTH, WIDTH, device="cpu", num_classes=NC)).trainable()
    cast_floating(model, torch.bfloat16)
    task = DefaultTask(model, **cfg)
    return task, TrainState(model, *task.make_optimizer())


def _worst(want, got):
    return max(leaf_errors(want, got))


def test_cast_floating_and_count_params_match_jax(params):
    model = params_from_jax(params, YOLO(DEPTH, WIDTH, device="cpu", num_classes=NC))
    assert count_params(model) == jax_count_params(params)
    assert count_params(params) == jax_count_params(params)
    tree = {"a": np.ones(3, np.float32), "b": [np.arange(2), torch.ones(2)]}
    cast = cast_floating(tree, torch.bfloat16)
    assert cast["a"].dtype == torch.bfloat16 and cast["b"][1].dtype == torch.bfloat16
    assert cast["b"][0].dtype == torch.int64
    assert cast_floating(model, torch.bfloat16) is model
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("name", CONFIGS)
def test_bf16_sgd_steps_match_jax(params, jax_runs, name, steps):
    states, metrics = jax_runs[name]
    task, state = _port_state(params, CONFIGS[name])
    for i in range(steps):
        images, targets, mask = _batch(i)
        state, m = task.train_step(state, torch.from_numpy(images).to(torch.bfloat16),
                                   torch.from_numpy(targets), torch.from_numpy(mask))
        for key, want in metrics[i].items():
            assert m[key].dtype == torch.float32
            np.testing.assert_allclose(float(m[key]), want, rtol=TOL["loss"], err_msg=key)
    assert {p.dtype for p in state.model.parameters()} == {torch.bfloat16}
    bufs = [state.optimizer.state[p]["momentum_buffer"] for p in state.model.parameters()]
    assert {b.dtype for b in bufs} == {torch.bfloat16}
    worst = _worst(_f32(states[steps - 1].params), params_to_jax(state.model))
    assert worst[0] <= TOL["param"], worst
    trace = params_to_jax(state.model,
                          leaf=lambda p: state.optimizer.state[p]["momentum_buffer"])
    worst = _worst(_f32(states[steps - 1].opt_state[1][0].trace), trace)
    assert worst[0] <= TOL["trace"], worst
