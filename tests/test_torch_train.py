"""The port's training path (``yolort_tpu_torch.trainer``) against the JAX
package's: gradients, SGD steps, the LR schedule, the EMA, early
stopping, train-state checkpoints both ways, ``fit`` and the train CLI.
Tiny model (depth 0.33, width 0.125, 8 classes), 64x64, batch 2, f32 on
the CPU.

Tolerances, each relative to the leaf's largest |value| in the JAX tree:
gradients 2e-5 (measured worst 1.5e-6: two frameworks' f32 convolutions
sum in different orders); params after SGD steps and after ``fit`` 1e-6
(measured worst 6e-8: the gradient error times the LR, plus rounding of
the update; a missing weight decay moves them by 5e-6 a step); the
momentum trace 2e-5 (measured worst 6e-7: a sum of gradients); the EMA
1e-6 (measured exact: three blends of the same numbers).  Loss terms rtol
1e-5.  The schedule's LR within 1e-6 of the base LR: the two libraries'
float32 cosines differ by an ulp, and near the end of the decay
1 + (frac - 1) * (1 - cos) / 2 cancels to a value far below the base.  A
train state read from a file is held bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import DEPTH, WIDTH, leaf_errors, random_targets, randomize_convs, to_numpy
from yolort_tpu.models._checkpoint import load_params as jax_load_params
from yolort_tpu.models.yolo import YOLO as JaxYOLO
from yolort_tpu.trainer import checkpoint as jckpt
from yolort_tpu.trainer import fit as jfit
from yolort_tpu.trainer import utils as jutils
from yolort_tpu.trainer.task import DefaultTask as JaxTask
from yolort_tpu.trainer.task import TrainState as JaxState
from yolort_tpu_torch.models._bridge import params_from_jax, params_to_jax
from yolort_tpu_torch.models.yolo import YOLO
from yolort_tpu_torch.ops.blocks import Conv
from yolort_tpu_torch.trainer import checkpoint as tckpt
from yolort_tpu_torch.trainer import fit as tfit
from yolort_tpu_torch.trainer import utils as tutils
from yolort_tpu_torch.trainer.task import DefaultTask, TrainState

NC = 8
CONFIGS = {
    "constant": dict(lr=0.01, momentum=0.9, weight_decay=5e-4),
    "scheduled": dict(lr=0.02, momentum=0.937, weight_decay=5e-4, total_steps=6, warmup_steps=2,
                      final_lr_frac=0.2),
}
STEPS = 3


def _batch(seed: int):
    images = np.random.default_rng(seed).random((2, 64, 64, 3)).astype(np.float32)
    targets, mask = random_targets(seed, nc=NC)
    return images, targets, mask


def _port_model(params) -> YOLO:
    tm = YOLO(DEPTH, WIDTH, device="cpu", num_classes=NC)
    return params_from_jax(params, tm).trainable()


def _port_state(params, cfg) -> tuple:
    task = DefaultTask(_port_model(params), **cfg)
    return task, TrainState(task.model, *task.make_optimizer())


def _port_step(task, state, seed):
    return task.train_step(state, *(torch.from_numpy(a) for a in _batch(seed)))


def _jax_trace(opt_state):
    return to_numpy(opt_state[1][0].trace)


def _port_trace(state):
    return params_to_jax(state.model, leaf=lambda p: state.optimizer.state[p]["momentum_buffer"])


def _assert_close(want, got, tol, what):
    errs = leaf_errors(want, got)
    worst = max(errs)
    assert worst[0] <= tol, f"{what}: worst leaf {worst[1]} at {worst[0]:.3g} (> {tol})"


@pytest.fixture(scope="module")
def jmodel():
    return JaxYOLO(DEPTH, WIDTH, num_classes=NC)


@pytest.fixture(scope="module")
def params(jmodel):
    init = jmodel.init(jax.random.PRNGKey(0))
    return {"init": to_numpy(init), "randomized": randomize_convs(init, 0)}


@pytest.fixture(scope="module")
def jax_runs(jmodel, params):
    """Per config: the JAX task, its jitted step, and STEPS steps from the
    randomized params on batches 0..STEPS-1 (states and metrics)."""
    runs = {}
    for name, cfg in CONFIGS.items():
        task = JaxTask(jmodel, **cfg)
        step = jax.jit(task.train_step)
        p0 = jax.tree_util.tree_map(jnp.asarray, params["randomized"])
        states, metrics = [JaxState(p0, task.tx.init(p0), jnp.zeros((), jnp.int32))], []
        for i in range(STEPS):
            s, m = step(states[-1], *(jnp.asarray(a) for a in _batch(i)))
            states.append(s)
            metrics.append({k: float(v) for k, v in m.items()})
        runs[name] = dict(task=task, step=step, states=states, metrics=metrics)
    return runs


@pytest.mark.parametrize("which", ["init", "randomized"])
def test_every_gradient_leaf_matches_jax(jmodel, params, which):
    """Every leaf, the trained BatchNorm mean and var included, at JAX's
    init and at random BatchNorm statistics with half the convs fused."""
    p = params[which]
    images, targets, mask = _batch(7)
    (jtot, jl), jg = jax.jit(jax.value_and_grad(JaxTask(jmodel).loss_fn, has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(images), jnp.asarray(targets),
        jnp.asarray(mask))
    tm = _port_model(p)
    ttot, tl = DefaultTask(tm).loss_fn(torch.from_numpy(images), torch.from_numpy(targets),
                                       torch.from_numpy(mask))
    ttot.backward()
    for key in jl:
        np.testing.assert_allclose(float(tl[key]), float(jl[key]), rtol=1e-5, err_msg=key)
    got = params_to_jax(tm, leaf=lambda q: q.grad)
    names = {path.rsplit("/", 1)[1] for _, path in leaf_errors(got, got)}
    assert {"mean", "var", "gamma", "beta", "w"} <= names
    if which == "randomized":
        assert "b" in names
    _assert_close(to_numpy(jg), got, 2e-5, f"gradients at {which}")


@pytest.mark.parametrize("name", CONFIGS)
def test_three_sgd_steps_match_jax(params, jax_runs, name):
    run = jax_runs[name]
    task, state = _port_state(params["randomized"], CONFIGS[name])
    for i in range(STEPS):
        # the LR of this step, as the optimizer holds it
        lr = state.optimizer.param_groups[0]["lr"]
        np.testing.assert_allclose(lr, _jax_lr(run["task"], i), rtol=0, atol=1e-6 * task.lr)
        state, metrics = _port_step(task, state, i)
        for key, want in run["metrics"][i].items():
            np.testing.assert_allclose(float(metrics[key]), want, rtol=1e-5, err_msg=key)
        _assert_close(to_numpy(run["states"][i + 1].params), params_to_jax(state.model), 1e-6,
                      f"params after step {i + 1}")
    assert state.step == STEPS
    if state.scheduler is not None:
        assert state.scheduler.last_epoch == int(run["states"][-1].opt_state[1][1].count)
    _assert_close(_jax_trace(run["states"][-1].opt_state), _port_trace(state), 2e-5,
                  "momentum trace")


def _jax_lr(jtask, count):
    if not jtask.total_steps:
        return jtask.lr
    return float(jutils.one_cycle_schedule(jtask.lr, jtask.final_lr_frac, jtask.total_steps,
                                           jtask.warmup_steps)(count))


@pytest.mark.parametrize("total,warmup,frac", [(6, 2, 0.2), (100, 0, 0.1), (50, 10, 0.01)])
def test_schedule_matches_jax(total, warmup, frac):
    js = jutils.one_cycle_schedule(0.01, frac, total, warmup)
    ts = tutils.one_cycle_schedule(0.01, frac, total, warmup)
    for step in range(total + 3):
        np.testing.assert_allclose(ts(step), float(js(step)), rtol=1e-6, atol=1e-6 * 0.01)
    for x in (0, 3, 7):
        assert tutils.one_cycle(0.1, 1.0, 10)(x) == jutils.one_cycle(0.1, 1.0, 10)(x)


def test_model_ema_matches_jax(params):
    p0 = params["randomized"]
    rng = np.random.default_rng(3)
    updates = [jax.tree_util.tree_map(
        lambda a: (a + rng.standard_normal(a.shape) * 0.1).astype(np.float32), p0)
        for _ in range(3)]
    jema = jutils.ModelEMA(decay=0.9, tau=2.0, params=jax.tree_util.tree_map(jnp.asarray, p0))
    tema = tutils.ModelEMA(decay=0.9, tau=2.0, model=_port_model(p0))
    for u in updates:
        jema.update(jax.tree_util.tree_map(jnp.asarray, u))
        tema.update(_port_model(u))
    assert tema.updates == jema.updates == 3
    _assert_close(to_numpy(jema.params), params_to_jax(tema.model), 1e-6, "EMA")
    assert not any(q.requires_grad for q in tema.model.parameters())
    # with no model given, the first update copies
    first = tutils.ModelEMA()
    first.update(_port_model(p0))
    _assert_close(p0, params_to_jax(first.model), 0.0, "first EMA update")


def test_early_stopping_matches_jax():
    fitness = [0.1, 0.3, 0.2, 0.3, 0.25, 0.2, 0.1, 0.4, 0.1, 0.1]
    js, ts = jutils.EarlyStopping(patience=3), tutils.EarlyStopping(patience=3)
    assert [ts(e, f) for e, f in enumerate(fitness)] == [js(e, f) for e, f in enumerate(fitness)]
    assert (ts.best_fitness, ts.best_epoch) == (js.best_fitness, js.best_epoch)


def test_jax_train_state_resumes_in_the_port(tmp_path, params, jax_runs):
    run = jax_runs["scheduled"]
    path = str(tmp_path / "jax_state.npz")
    jckpt.save_train_state(path, jax.device_get(run["states"][2]), {"who": "jax"})
    task = DefaultTask(YOLO(DEPTH, WIDTH, device="cpu", num_classes=NC), **CONFIGS["scheduled"])
    state, meta = tckpt.load_train_state(path, task)
    assert meta == {"who": "jax"} and state.step == 2 and state.scheduler.last_epoch == 2
    _assert_close(to_numpy(run["states"][2].params), params_to_jax(state.model), 0.0, "params")
    _assert_close(_jax_trace(run["states"][2].opt_state), _port_trace(state), 0.0, "trace")
    state, metrics = _port_step(task, state, 2)
    for key, want in run["metrics"][2].items():
        np.testing.assert_allclose(float(metrics[key]), want, rtol=1e-5, err_msg=key)
    _assert_close(to_numpy(run["states"][3].params), params_to_jax(state.model), 1e-6,
                  "params after the resumed step")


def test_train_state_from_jax_in_memory(jax_runs):
    """A JAX TrainState's numpy contents, no file: the same state as the
    file path gives."""
    run = jax_runs["scheduled"]
    js = jax.device_get(run["states"][3])
    task = DefaultTask(YOLO(DEPTH, WIDTH, device="cpu", num_classes=NC), **CONFIGS["scheduled"])
    state = tckpt.train_state_from_jax(to_numpy(js.params),
                                       [np.asarray(x) for x in jax.tree_util.tree_leaves(js.opt_state)],
                                       int(js.step), task)
    assert state.step == 3 and state.scheduler.last_epoch == 3
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(_jax_lr(run["task"], 3), rel=1e-6)
    _assert_close(to_numpy(js.params), params_to_jax(state.model), 0.0, "params")
    _assert_close(_jax_trace(js.opt_state), _port_trace(state), 0.0, "trace")


def test_port_train_state_resumes_in_jax(tmp_path, params, jax_runs):
    run = jax_runs["scheduled"]
    task, state = _port_state(params["randomized"], CONFIGS["scheduled"])
    for i in range(2):
        state, _ = _port_step(task, state, i)
    path = str(tmp_path / "port_state.npz")
    tckpt.save_train_state(path, state, {"who": "port"})
    jstate, meta = jckpt.load_train_state(path, run["task"])
    assert meta == {"who": "port"} and int(jstate.step) == 2
    assert int(jstate.opt_state[1][1].count) == 2
    _assert_close(params_to_jax(state.model), to_numpy(jstate.params), 0.0, "params")
    _assert_close(_port_trace(state), _jax_trace(jstate.opt_state), 0.0, "trace")
    jstate, _ = run["step"](jstate, *(jnp.asarray(a) for a in _batch(2)))
    state, _ = _port_step(task, state, 2)
    _assert_close(to_numpy(jstate.params), params_to_jax(state.model), 1e-6,
                  "params after JAX's resumed step")
    # and the port's own file round trip is exact
    again, _ = tckpt.load_train_state(path, DefaultTask(YOLO(DEPTH, WIDTH, device="cpu",
                                                             num_classes=NC),
                                                        **CONFIGS["scheduled"]))
    assert again.step == 2 and again.scheduler.last_epoch == 2


def test_constant_lr_state_round_trips_and_strips(tmp_path, params, jax_runs):
    task, state = _port_state(params["randomized"], CONFIGS["constant"])
    state, _ = _port_step(task, state, 0)
    path, out = str(tmp_path / "s.npz"), str(tmp_path / "stripped.npz")
    tckpt.save_train_state(path, state)
    jstate, _ = jckpt.load_train_state(path, jax_runs["constant"]["task"])
    _assert_close(_port_trace(state), _jax_trace(jstate.opt_state), 0.0, "trace")
    assert tckpt.strip_optimizer(path, out) == out
    got, meta = jax_load_params(out)
    assert meta["stripped"] is True
    _assert_close(params_to_jax(state.model), to_numpy(got), 0.0, "stripped params")
    # a state of the other optimizer layout is refused
    with pytest.raises(ValueError, match="optimizer leaves"):
        tckpt.load_train_state(path, DefaultTask(_port_model(params["randomized"]),
                                                 **CONFIGS["scheduled"]))


def test_init_train_is_jax_init_form(params):
    """init_train gives JAX's tree (every conv unfused), identity
    BatchNorm, trainable leaves, the same draws for one seed, and the
    prior-probability head bias."""
    a = YOLO(DEPTH, WIDTH, device="cpu", num_classes=NC).init_train(5)
    b = YOLO(DEPTH, WIDTH, device="cpu", num_classes=NC, seed=9).init_train(5)
    ta, tb = params_to_jax(a), params_to_jax(b)
    _assert_close(ta, tb, 0.0, "same seed")
    _assert_close(params["init"], ta, np.inf, "JAX init tree")  # keys and shapes
    assert all(q.requires_grad for q in a.parameters())
    for m in a.modules():
        if isinstance(m, Conv):
            assert m.bias is None
            assert torch.equal(m.gamma, torch.ones_like(m.gamma))
            assert torch.equal(m.var, torch.ones_like(m.var))
            assert not m.mean.any() and not m.beta.any()
    head_b = ta["head"]["0"]["b"].reshape(3, NC + 5)
    jax_b = params["init"]["head"]["0"]["b"].reshape(3, NC + 5)
    assert abs(head_b[:, 4].mean() - jax_b[:, 4].mean()) < 0.2  # both log(8 / 80^2) + U(-b, b)
    with torch.no_grad():  # the tree is a copy, not a view of the parameters
        for q in a.parameters():
            q.add_(1.0)
    _assert_close(tb, ta, 0.0, "tree after the parameters moved")


def test_int8_model_refuses_to_train():
    tm = YOLO(DEPTH, WIDTH, device="cpu", num_classes=NC)
    conv = next(m for m in tm.modules() if isinstance(m, Conv))
    c1, c2 = conv.weight.shape[1], conv.weight.shape[0]
    k = conv.weight.shape[2]
    conv.set_int8(np.zeros((k, k, c1, c2), np.int8), np.ones(c2, np.float32), 1.0)
    with pytest.raises(ValueError, match="int8"):
        DefaultTask(tm).init_state(0)
    with pytest.raises(ValueError, match="int8"):
        tm.trainable()


def _dataset(seed: int, n: int = 4, hw: int = 64):
    rng = np.random.default_rng(seed)
    items = []
    for _ in range(n):
        img = rng.uniform(0.0, 0.3, (hw, hw, 3)).astype(np.float32)
        boxes = []
        for _ in range(int(rng.integers(1, 3))):
            x, y = rng.integers(0, hw - 24, 2)
            w, h = rng.integers(12, 24, 2)
            img[y:y + h, x:x + w] = rng.uniform(0.7, 1.0, 3)
            boxes.append([x, y, x + w, y + h])
        boxes = np.asarray(boxes, np.float32)
        items.append((img, {"boxes": boxes, "labels": rng.integers(0, NC, len(boxes)),
                            "orig_size": np.asarray([hw, hw])}))
    return items


class _Recorder:
    """A MetricLogger that keeps every update."""

    def __init__(self, real):
        self.real, self.seen = real, []

    def __call__(self, *a, **kw):
        logger = self.real(*a, **kw)
        update = logger.update

        def record(**values):
            self.seen.append(dict(values))
            update(**values)

        logger.update = record
        return logger


def test_fit_matches_jax(tmp_path, monkeypatch, jmodel, params):
    """fit, 2 epochs x 2 batches with the EMA and a checkpoint each epoch:
    the logged losses and the final (EMA) params against JAX's fit."""
    from yolort_tpu.data.data_module import DetectionDataModule as JDM
    from yolort_tpu_torch.data.data_module import DetectionDataModule as TDM

    data = _dataset(11)
    kw = dict(batch_size=2, canvas_hw=(64, 64), min_size=64, max_size=64, max_targets_per_image=4)
    cfg = dict(lr=0.01, momentum=0.9, weight_decay=5e-4, total_steps=4, warmup_steps=1)
    jrec, trec = _Recorder(jfit.MetricLogger), _Recorder(tfit.MetricLogger)
    monkeypatch.setattr(jfit, "MetricLogger", jrec)
    monkeypatch.setattr(tfit, "MetricLogger", trec)

    jtask = JaxTask(jmodel, **cfg)
    p0 = jax.tree_util.tree_map(jnp.asarray, params["randomized"])
    jstate = jfit.fit(jtask, JDM(data, **kw), max_epochs=2, use_ema=True, print_freq=100,
                      state=JaxState(p0, jtask.tx.init(p0), jnp.zeros((), jnp.int32)),
                      checkpoint_path=str(tmp_path / "jax.npz"))
    task, state = _port_state(params["randomized"], cfg)
    state = tfit.fit(task, TDM(data, **kw), max_epochs=2, use_ema=True, print_freq=100,
                     state=state, checkpoint_path=str(tmp_path / "port.npz"))

    assert len(trec.seen) == len(jrec.seen) == 4 and state.step == 4
    for got, want in zip(trec.seen, jrec.seen):
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    _assert_close(to_numpy(jstate.params), params_to_jax(state.model), 1e-6, "params after fit")
    saved, meta = jax_load_params(str(tmp_path / "port.npz"))
    assert meta == {"epoch": 1}
    _assert_close(to_numpy(jax_load_params(str(tmp_path / "jax.npz"))[0]), to_numpy(saved), 1e-6,
                  "checkpoints")


def test_fit_evaluates_through_the_serving_path(params):
    """With validation data, fit's evaluation serves the EMA model and
    returns finite COCO metrics; early stopping reads them."""
    from yolort_tpu_torch.data.data_module import DetectionDataModule as TDM

    kw = dict(batch_size=2, canvas_hw=(64, 64), min_size=64, max_size=64, max_targets_per_image=4)
    task, state = _port_state(params["randomized"], CONFIGS["constant"])
    val = TDM(_dataset(12, n=3), **kw)
    task.model.score_thresh = 0.0
    results = tfit.evaluate(task.model, val, val.canvas_hw)
    # the 64x64 frames hold no box of the COCO 'large' area range: APl is NaN
    assert all(np.isfinite(results[k]) for k in ("AP", "AP50", "AP75", "APs"))
    state = tfit.fit(task, TDM(_dataset(11), **kw), val, max_epochs=3, patience=1,
                     print_freq=100, state=state)
    assert 2 <= state.step <= 6
    # training after an evaluation still builds a graph
    _port_step(task, state, 0)


def test_train_cli_writes_npz_that_jax_reads(tmp_path):
    from yolort_tpu.models.yolo import build_yolo as jax_build
    from yolort_tpu_torch.data._helper import create_synthetic_coco
    from yolort_tpu_torch.tools.train import cli_main

    img_dir, ann = create_synthetic_coco(str(tmp_path / "data"), num_images=4, num_classes=3)
    out = str(tmp_path / "trained.npz")
    args = ["--arch", "yolov5_darknet_pan_n_r60", "--num_classes", "3", "--image_path", img_dir,
            "--annotation_path", ann, "--batch_size", "2", "--image_size", "64", "--max_epochs",
            "1", "--output_path", out]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli_main(args)  # the card is the default device, and there is none here
    cli_main(args + ["--device", "cpu", "--val_annotation_path", ann])
    got, meta = jax_load_params(out)
    assert meta == {"epoch": 0}
    jm = jax_build("yolov5_darknet_pan_n_r60", num_classes=3)
    kb, kp, kh = jax.random.split(jax.random.PRNGKey(0), 3)
    want = {"backbone": jax.eval_shape(jm.backbone.init, kb), "pan": jax.eval_shape(jm.pan.init, kp),
            "head": jm.head.init(kh)}
    errs = leaf_errors(jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), want),
                       to_numpy(got))  # same keys and shapes
    assert len(errs) > 0 and all(np.isfinite(e) for e, _ in errs)
