"""Letterbox plan, letterbox and inverse box transform: port against JAX.

The plan is pure Python and must agree field for field; the resized pixels
within 1e-5 (both are half-pixel bilinear without antialias, computed in
float32 in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolort_tpu.models import transform as JT
from yolort_tpu_torch.models import transform as TT

SIZES = [(480, 640), (1080, 810), (333, 517), (640, 640), (17, 900), (721, 1281), (100, 90)]


@pytest.mark.parametrize("fixed", [None, (640, 672)])
@pytest.mark.parametrize("div", [32, 64])
def test_make_plan_equal(div, fixed):
    for sizes in ([s] for s in SIZES):
        assert TT.make_plan(sizes, 640, 640, div, fixed) == [
            TT.LetterboxPlan(p.orig_hw, p.resized_hw, p.canvas_hw, p.offset_hw)
            for p in JT.make_plan(sizes, 640, 640, div, fixed)
        ]
    both = TT.make_plan(SIZES, 512, 768, div)
    assert [(p.resized_hw, p.canvas_hw, p.offset_hw) for p in both] == [
        (p.resized_hw, p.canvas_hw, p.offset_hw) for p in JT.make_plan(SIZES, 512, 768, div)
    ]


@pytest.mark.parametrize("hw,size", [((96, 128), 64), ((50, 75), 96), ((64, 64), 64), ((37, 53), 80)])
def test_letterbox_batch_matches_jax(hw, size):
    x = np.random.default_rng(0).random((2, *hw, 3)).astype(np.float32)
    plan = JT.make_plan([hw], size, size, 32)[0]
    want = np.asarray(JT.letterbox_batch(jnp.asarray(x), plan))
    tplan = TT.make_plan([hw], size, size, 32)[0]
    got = TT.letterbox_batch(torch.from_numpy(x), tplan)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # the pad is exactly the fill colour
    dh, dw = tplan.offset_hw
    if dh:
        assert (got[:, :dh] == torch.tensor(114.0 / 255.0)).all()


def test_scale_coords_back_matches_jax():
    rng = np.random.default_rng(1)
    boxes = (rng.random((3, 7, 4)) * 640).astype(np.float32)
    orig = np.asarray([[480, 640], [1080, 810], [333, 517]], np.float32)
    want = np.asarray(JT.scale_coords_back(jnp.asarray(boxes), (640, 640), jnp.asarray(orig)[:, None, :]))
    got = TT.scale_coords_back(torch.from_numpy(boxes), (640, 640), torch.from_numpy(orig)[:, None, :])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-6)
