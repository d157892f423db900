"""The port's YOLOv5 loss (``yolort_tpu_torch.models.losses``) against the
JAX package's on the same numpy inputs, f32 on the CPU.

Tolerances: each loss term within rtol 1e-5 (a sum over every cell of
float32 BCE terms, accumulated in another order); the gradient of each
level's logits within 1e-5 of its largest |g|.  The duplicate-cell rule
(the later candidate's IoU wins a cell) is held exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import random_heads, random_targets
from yolort_tpu.models import losses as JL
from yolort_tpu_torch.models import losses as TL
from yolort_tpu_torch.models.head import DEFAULT_ANCHOR_GRIDS, DEFAULT_STRIDES

NC = 8
GRIDS = ((8, 8), (4, 4), (2, 2))  # a 64x64 canvas


def _targets(case: str):
    tg, mask = random_targets(1, nc=NC)
    if case == "empty":
        mask[:] = False
    elif case == "cell_edges":
        # centres on cell boundaries and the canvas edge at every level
        tg[0, :3, 1:3] = [[0.5, 0.5], [0.25, 0.125], [0.0, 1.0]]
        tg[1, :2, 1:3] = [[1.0, 0.0], [0.125, 0.75]]
    elif case == "duplicate_cell":
        # two targets on one cell and anchor, with different boxes
        tg[0, 1, 1:3] = tg[0, 0, 1:3]
        tg[0, 1, 3:5] = tg[0, 0, 3:5] * 1.05
        tg[1, 1, 1:3] = tg[1, 0, 1:3] + 0.001
    return tg, mask


CASES = {
    "plain": ("plain", {}),
    "empty": ("empty", {}),
    "cell_edges": ("cell_edges", {}),
    "duplicate_cell": ("duplicate_cell", {}),
    "label_smoothing": ("plain", {"label_smoothing": 0.1}),
    "focal": ("plain", {"fl_gamma": 1.5}),
    "qfocal": ("plain", {"fl_gamma": 1.5, "use_qfocal": True}),
    "gains": ("plain", {"box_gain": 0.1, "cls_gain": 0.3, "obj_gain": 0.7, "cls_pos": 2.0,
                        "obj_pos": 0.5, "anchor_thresh": 3.0}),
}


@pytest.mark.parametrize("name", CASES)
def test_loss_terms_and_logit_grads_match_jax(name):
    case, kw = CASES[name]
    heads = random_heads(3, GRIDS, nc=NC, shift=-2.0)
    tg, mask = _targets(case)
    cfg = dict(strides=DEFAULT_STRIDES, anchor_grids=DEFAULT_ANCHOR_GRIDS, num_classes=NC, **kw)
    jloss, tloss = JL.YOLOLoss(**cfg), TL.YOLOLoss(**cfg)

    def jtotal(hs):
        d = jloss(hs, jnp.asarray(tg), jnp.asarray(mask))
        return d["cls_logits"] + d["bbox_regression"] + d["objectness"], d

    (_, jd), jg = jax.value_and_grad(jtotal, has_aux=True)([jnp.asarray(h) for h in heads])
    th = [torch.from_numpy(h).requires_grad_(True) for h in heads]
    td = tloss(th, torch.from_numpy(tg), torch.from_numpy(mask))
    sum(td.values()).backward()
    for key in ("cls_logits", "bbox_regression", "objectness"):
        np.testing.assert_allclose(float(td[key]), float(jd[key]), rtol=1e-5, atol=1e-12,
                                   err_msg=key)
    if case == "empty":
        assert float(td["bbox_regression"]) == 0.0 and float(td["cls_logits"]) == 0.0
    for g, w in zip(th, jg):
        w = np.asarray(w)
        np.testing.assert_allclose(g.grad.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_duplicate_cell_case_has_a_duplicate():
    """The duplicate case does put two candidates with different IoU
    targets on one cell and anchor, so the rule is exercised."""
    tg, mask = _targets("duplicate_cell")
    gxy = tg[0, :2, 1:3] * np.asarray(GRIDS[0][::-1])
    assert np.array_equal(np.floor(gxy[0]), np.floor(gxy[1]))
    assert not np.array_equal(tg[0, 0, 3:5], tg[0, 1, 3:5])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_last_write_scatter_matches_jax_set(seed):
    """JAX's .at[idx].set(mode='drop') on the CPU keeps the last update of a
    duplicate index; the port resolves the same winner deterministically."""
    rng = np.random.default_rng(seed)
    size = 13
    idx = rng.integers(0, size + 1, (3, 40))  # size = dropped
    val = rng.random((3, 40)).astype(np.float32)
    want = jax.vmap(lambda i, v: jnp.zeros(size).at[i].set(v, mode="drop"))(
        jnp.asarray(idx), jnp.asarray(val))
    got = TL.last_write_scatter(torch.from_numpy(idx), torch.from_numpy(val), size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_elementwise_terms_match_jax():
    rng = np.random.default_rng(4)
    b1 = np.concatenate([rng.uniform(0, 8, (64, 2)), rng.uniform(0.1, 4, (64, 2))], -1)
    b2 = np.concatenate([rng.uniform(0, 8, (64, 2)), rng.uniform(0.1, 4, (64, 2))], -1)
    b1, b2 = b1.astype(np.float32), b2.astype(np.float32)
    np.testing.assert_allclose(TL.bbox_ciou(torch.from_numpy(b1), torch.from_numpy(b2)).numpy(),
                               np.asarray(JL.bbox_ciou(jnp.asarray(b1), jnp.asarray(b2))),
                               rtol=1e-5, atol=1e-6)
    x = rng.standard_normal(200).astype(np.float32) * 4
    t = rng.random(200).astype(np.float32)
    tx, tt = torch.from_numpy(x), torch.from_numpy(t)
    jx, jt = jnp.asarray(x), jnp.asarray(t)
    np.testing.assert_allclose(TL.bce_with_logits(tx, tt, 2.0).numpy(),
                               np.asarray(JL.bce_with_logits(jx, jt, 2.0)), rtol=1e-5, atol=1e-6)
    for quality in (False, True):
        np.testing.assert_allclose(
            TL.focal_bce_with_logits(tx, tt, 1.5, 0.25, 1.0, quality).numpy(),
            np.asarray(JL.focal_bce_with_logits(jx, jt, 1.5, 0.25, 1.0, quality)),
            rtol=1e-5, atol=1e-6)
    assert TL.smooth_bce_targets(0.1) == JL.smooth_bce_targets(0.1)


def test_pad_targets_matches_jax_on_the_given_device():
    per = [{"labels": np.asarray([1, 2, 3]), "boxes_cxcywh_norm": np.full((3, 4), 0.25)},
           {"labels": np.asarray([], np.int64), "boxes_cxcywh_norm": np.zeros((0, 4))}]
    tt, tm = TL.pad_targets(per, 2, device="cpu")
    jt, jm = JL.pad_targets(per, 2)
    assert tt.device.type == "cpu" and tt.dtype == torch.float32 and tm.dtype == torch.bool
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
