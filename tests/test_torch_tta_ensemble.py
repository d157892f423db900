"""Ensemble, test-time augmentation and pruning in the port against the
JAX package, float32 on the CPU.

- Two nano yolov5 members (params of JAX's ``init`` layout drawn with
  numpy, random BatchNorm statistics, every other conv folded, head
  biases raised to a candidate load), carried across: ``Ensemble.decode``
  (the pooled decoded predictions) and ``tta_decode`` within 1e-4 of the
  largest |value| of JAX's pool (the members' ``decode`` concatenated;
  JAX's ``scale_img``, flip and un-scale of ``tta_inference``), and the
  scores within atol 1e-4.  ``Ensemble`` and ``tta_inference`` give the
  Detections of JAX's ``batched_postprocess`` (``topk_impl='bisect'``) of
  that same pooled tensor: count, valid, labels and order exactly, scores
  and boxes within rtol 1e-6.
- ``scale_img`` within 1e-5 of JAX's at ratios 1.0, 0.83 and 0.67,
  borders and padding included.
- tests/test_tta_prune.py's checks: the identity variant is plain
  inference, a flip-only variant of a mirrored input keeps about as many
  detections as the plain one.
- ``prune`` zeroes what JAX's ``prune`` zeroes, leaf by leaf, leaves its
  argument as it was, and ``sparsity`` is JAX's on the same params.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_zoo_blocks import numpy_params
from torch_parity import randomize_convs, shift_head_bias
from yolort_tpu.models import tta as JT
from yolort_tpu.models.yolo import YOLO as JaxYOLO
from yolort_tpu.ops import nms as JN
from yolort_tpu.utils import prune as JP
from yolort_tpu_torch.models import YOLOv5
from yolort_tpu_torch.models._bridge import params_from_jax, params_to_jax
from yolort_tpu_torch.models._checkpoint import _flatten
from yolort_tpu_torch.models.ensemble import Ensemble
from yolort_tpu_torch.models.tta import scale_img, tta_decode, tta_inference
from yolort_tpu_torch.models.yolo import YOLO
from yolort_tpu_torch.utils.prune import prune, sparsity

NANO = (0.33, 0.25)
NC = 4
POST = dict(score_thresh=0.05, nms_thresh=0.45, detections_per_img=300, pre_nms_topk=512)


def member(seed: int, shift: float = 3.0):
    """(JAX YOLO, its numpy params, the port YOLO on the CPU) at nano width."""
    jm = JaxYOLO(*NANO, num_classes=NC)
    kh = jax.random.split(jax.random.PRNGKey(seed))[1]
    params = {"backbone": numpy_params(jm.backbone.init, seed),
              "pan": numpy_params(jm.pan.init, seed + 100), "head": jm.head.init(kh)}
    params = shift_head_bias(randomize_convs(params, seed), shift)
    tm = params_from_jax(params, YOLO(*NANO, device="cpu", num_classes=NC, **POST))
    return jm, params, tm


@pytest.fixture(scope="module")
def members():
    return member(0), member(1)


@pytest.fixture(scope="module")
def images():
    return np.random.default_rng(2).random((2, 96, 128, 3)).astype(np.float32)


def _close_pool(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got[..., 4:], want[..., 4:], atol=1e-4, rtol=0)


def _same_detections(got, pooled: torch.Tensor):
    want = jax.jit(lambda p: JN.batched_postprocess(p, num_classes=NC, topk_impl="bisect",
                                                    nms_impl="xla", **POST))(
        jnp.asarray(pooled.numpy()))
    assert (got.num.numpy() > 0).all()
    np.testing.assert_array_equal(got.num.numpy(), np.asarray(want.num))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-6, atol=1e-5)


def test_ensemble_matches_jax(members, images):
    (j1, p1, t1), (j2, p2, t2) = members
    ens = Ensemble([t1, t2])
    x = torch.from_numpy(images)
    want = jax.jit(lambda a, b, x: jnp.concatenate([j1.decode(a, x), j2.decode(b, x)], axis=1))(
        p1, p2, jnp.asarray(images))
    with torch.no_grad():
        pooled = ens.decode(x)
        det = ens(x)
    assert pooled.shape[1] == 2 * 3 * (12 * 16 + 6 * 8 + 3 * 4)
    _close_pool(pooled, want)
    _same_detections(det, pooled)
    # served as a model, and members of other class counts refused
    out = YOLOv5(model=ens, size=(96, 128))(list((images * 255).astype(np.uint8)))
    assert all(len(d["scores"]) > 0 and (d["labels"] < NC).all() for d in out)
    other = YOLO(*NANO, device="cpu", num_classes=NC + 1)
    with pytest.raises(ValueError, match="num_classes"):
        Ensemble([t1, other])


def _jax_tta_pool(jm, params, x, scales=(1.0, 0.83, 0.67), flips=(False, True, False)):
    """The pool of JAX's ``tta_inference`` before its postprocess."""
    w = x.shape[2]
    preds = []
    for ratio, flip in zip(scales, flips):
        pred = jm.decode(params, JT.scale_img(x[:, :, ::-1, :] if flip else x, ratio))
        cx, cy, bw, bh = (pred[..., i] / ratio for i in range(4))
        if flip:
            cx = w - cx
        preds.append(jnp.concatenate([jnp.stack([cx, cy, bw, bh], -1), pred[..., 4:]], -1))
    return jnp.concatenate(preds, axis=1)


def test_tta_matches_jax(members, images):
    (jm, params, tm), _ = members
    x = torch.from_numpy(images)
    want = jax.jit(lambda p, x: _jax_tta_pool(jm, p, x))(params, jnp.asarray(images))
    with torch.no_grad():
        pooled = tta_decode(tm, x)
        det = tta_inference(tm, x)
    # 96x128, 79x106 padded to 96x128, 64x85 padded to 64x96
    assert pooled.shape[1] == 3 * (2 * 252 + (8 * 12 + 4 * 6 + 2 * 3))
    _close_pool(pooled, want)
    _same_detections(det, pooled)


@pytest.mark.parametrize("ratio", [1.0, 0.83, 0.67])
def test_scale_img_matches_jax(ratio):
    x = np.random.default_rng(3).random((2, 200, 300, 3)).astype(np.float32)
    want = np.asarray(JT.scale_img(jnp.asarray(x), ratio))
    got = scale_img(torch.from_numpy(x), ratio).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    if ratio != 1.0:  # resized, then padded up to multiples of 32
        assert got.shape[1] % 32 == 0 and got.shape[2] % 32 == 0
        assert (got[:, int(200 * ratio):] == np.float32(114 / 255)).all()


def test_tta_identity_and_flip_variants(members):
    """tests/test_tta_prune.py's two checks, on the port: the identity
    variant is plain inference (its pool is ``decode`` bit for bit, so its
    Detections are the decoded path's; the cell path orders this seeded
    network's near-tied scores its own way), and a flip-only variant of a
    mirrored input keeps about as many detections as the plain one."""
    (_, _, tm), _ = members
    x = torch.from_numpy(np.random.default_rng(4).random((1, 96, 96, 3)).astype(np.float32))
    with torch.no_grad():
        plain = tm.decode(x)
        assert torch.equal(tta_decode(tm, x, scales=(1.0,), flips=(False,)), plain)
        det = tta_inference(tm, x, scales=(1.0,), flips=(False,))
        base = tm.postprocess_decoded(plain)
        assert int(det.num[0]) > 0 and all(torch.equal(a, b) for a, b in zip(det, base))
        half = x[:, :, :48]
        sym = torch.cat([half, torch.flip(half, dims=[2])], dim=2)
        plain = tta_inference(tm, sym, scales=(1.0,), flips=(False,))
        flipped = tta_inference(tm, sym, scales=(1.0,), flips=(True,))
    assert abs(int(plain.num[0]) - int(flipped.num[0])) <= 2


def test_prune_and_sparsity_match_jax(members):
    (_, params, tm), _ = members
    before = _flatten(params_to_jax(tm))
    jpruned = JP.prune(params, amount=0.3)
    want = _flatten(jax.tree_util.tree_map(np.asarray, jpruned))
    pruned = prune(tm, amount=0.3)
    got = _flatten(params_to_jax(pruned))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)
    assert any((got[k] == 0).mean() > 0.25 for k in got if k.endswith("/w"))
    for key, w in _flatten(params_to_jax(tm)).items():  # the argument is untouched
        np.testing.assert_array_equal(w, before[key], err_msg=key)
    assert sparsity(tm) == JP.sparsity(params) < 0.01
    assert sparsity(pruned) == JP.sparsity(jpruned)
    assert 0.2 < sparsity(pruned) < 0.4
    with torch.no_grad():  # the pruned model still runs
        assert pruned.head_outputs(torch.zeros(1, 64, 64, 3))[0].shape[0] == 1
