"""``yolort_tpu_torch/utils/quant_probe.py`` against the JAX package's
``yolort_tpu/utils/quant_probe.py``, float32 on the CPU.

- ``make_scenes`` bit-equal to JAX's.
- The LR schedule of ``scene_optimizer``'s ``LambdaLR`` over 1000 steps
  within 1e-9 of optax's cosine decay formula (the first step at
  ``lr(0)``; no off-by-one).
- Three Adam steps of the harness's loop from JAX's ``PRNGKey(0)`` init
  carried across: every param within 1e-5 of its leaf's largest |value|
  (the BatchNorm beta and mean leaves 2e-4, where gradients near Adam's
  eps amplify float noise) of the same three steps of JAX's ``optax.adam``
  loop (the JAX loop reproduced here with ``steps=3``).
- ``eval_ap`` on identical params and images: the Detections of JAX's
  model (count, labels; boxes within 1e-3 px, scores within 1e-6) and the
  same AP.
- The whole harness (``train_scene_detector``, 1000 steps, then
  ``int8_ap_report``) under the bounds of tests/test_int8_ap_delta.py,
  marked slow as that test is; chip_smoke.py runs it on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_parity import leaf_errors, shift_head_bias, to_numpy
from yolort_tpu.models.losses import pad_targets as jax_pad_targets
from yolort_tpu.models.yolo import build_yolo as jax_build_yolo
from yolort_tpu.trainer import DefaultTask as JaxTask
from yolort_tpu.utils import quant_probe as JP
from yolort_tpu_torch.models._bridge import params_from_jax, params_to_jax
from yolort_tpu_torch.utils import quant_probe as TP

STEPS = 3


def test_make_scenes_is_jax_bit_for_bit():
    ti, tg = TP.make_scenes()
    ji, jg = JP.make_scenes()
    assert ti.dtype == ji.dtype and ti.shape == (4, TP.SCENE_SIZE, TP.SCENE_SIZE, 3)
    np.testing.assert_array_equal(ti, ji)
    for a, b in zip(tg, jg):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


def test_lr_schedule_is_the_cosine_formula():
    steps = 1000
    opt, sched = TP.scene_optimizer(torch.nn.Linear(2, 2), steps)
    got = []
    for _ in range(steps + 5):
        got.append(opt.param_groups[0]["lr"])
        opt.step()
        sched.step()
    t = np.minimum(np.arange(steps + 5), steps)
    want = 1e-3 * ((1 - 0.05) * 0.5 * (1 + np.cos(np.pi * t / steps)) + 0.05)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert got[0] == pytest.approx(1e-3, abs=1e-15) and got[steps] == pytest.approx(5e-5, abs=1e-12)
    optax_lr = optax.cosine_decay_schedule(1e-3, steps, alpha=0.05)
    np.testing.assert_allclose(got[:steps], [float(optax_lr(i)) for i in range(steps)],
                               rtol=1e-6)


@pytest.fixture(scope="module")
def jax_model():
    return jax_build_yolo("yolov5_darknet_pan_n_r60", num_classes=2, score_thresh=0.1,
                          pre_nms_topk=256, nms_tile_size=64)


def _jax_adam_steps(model, params, images, gts, steps):
    """JAX's ``train_scene_detector`` loop, ``steps`` steps."""
    size = images.shape[1]
    per_image = [
        {"labels": g["labels"],
         "boxes_cxcywh_norm": np.asarray(
             [[(b[0] + b[2]) / 2 / size, (b[1] + b[3]) / 2 / size,
               (b[2] - b[0]) / size, (b[3] - b[1]) / size] for b in g["boxes"]])}
        for g in gts
    ]
    targets, mask = jax_pad_targets(per_image, 4)
    task = JaxTask(model)
    tx = optax.adam(optax.cosine_decay_schedule(1e-3, steps, alpha=0.05))
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state):
        (total, _), grads = jax.value_and_grad(task.loss_fn, has_aux=True)(
            params, jnp.asarray(images), targets, mask)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, total

    for _ in range(steps):
        params, opt_state, total = step(params, opt_state)
    return to_numpy(params), float(total)


def test_three_adam_steps_match_jax(jax_model):
    images, gts = TP.make_scenes()
    init = jax_model.init(jax.random.PRNGKey(0))
    want, jtotal = _jax_adam_steps(jax_model, init, images, gts, STEPS)
    model = params_from_jax(to_numpy(init), TP.scene_model("cpu")).trainable()
    total = TP.train_scenes(model, images, gts, STEPS)
    assert total == pytest.approx(jtotal, rel=1e-4)
    # tolerance: 1e-5 of each leaf's largest |value|; the BatchNorm beta and
    # mean leaves 2e-4: on some channels their gradients are near Adam's
    # eps (1e-8), where the step g / (|g| + eps) turns the frameworks'
    # float noise in g into part of the step (9e-5 after 3 steps, 1.7e-4
    # after 1, measured)
    errs = leaf_errors(want, params_to_jax(model))
    bn = [e for e in errs if e[1].endswith(("/beta", "/mean"))]
    worst = max(e for e in errs if e not in bn)
    assert worst[0] <= 1e-5, f"worst leaf {worst[1]} at {worst[0]:.3g}"
    assert max(bn)[0] <= 2e-4, f"worst BatchNorm leaf {max(bn)[1]} at {max(bn)[0]:.3g}"


def test_eval_ap_detections_match_jax(jax_model):
    images, gts = TP.make_scenes()
    params = shift_head_bias(to_numpy(jax_model.init(jax.random.PRNGKey(0))), 4.0)
    model = params_from_jax(params, TP.scene_model("cpu"))
    want = jax.device_get(jax.jit(lambda p, x: jax_model(p, x))(params, jnp.asarray(images)))
    with torch.no_grad():
        got = model(torch.from_numpy(images))
    np.testing.assert_array_equal(got.num.numpy(), np.asarray(want.num))
    assert int(got.num.min()) > 0
    for i, n in enumerate(np.asarray(want.num)):
        np.testing.assert_array_equal(got.labels[i, :n].numpy(), np.asarray(want.labels[i, :n]))
        np.testing.assert_allclose(got.boxes[i, :n].numpy(), np.asarray(want.boxes[i, :n]),
                                   rtol=0, atol=1e-3)
        np.testing.assert_allclose(got.scores[i, :n].numpy(), np.asarray(want.scores[i, :n]),
                                   rtol=0, atol=1e-6)
    assert TP.eval_ap(model, images, gts) == JP.eval_ap(jax_model, params, images, gts)


@pytest.mark.slow
def test_int8_ap_delta():
    """tests/test_int8_ap_delta.py on the port: a converged scene detector
    loses at most 0.05 AP under the iterative skip-list recipe."""
    images, gts = TP.make_scenes()
    model = TP.train_scene_detector(images, gts, device="cpu")
    rep = TP.int8_ap_report(model, images, gts, target_delta=0.05)
    print(f"int8 AP report: {rep}")
    assert rep["float_ap"] >= 0.7, rep
    assert rep["int8_ap_all"] >= 0.5 * rep["float_ap"], rep
    assert rep["delta"] <= 0.05, rep
