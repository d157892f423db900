"""The postprocess: the same head logits through the port and through the
JAX program on the cell path it runs on an accelerator (passed explicitly:
on the CPU ``resolve_nms_config`` would pick the lax.top_k flatten path),
with the lookup kernels in interpret mode and the XLA greedy NMS.

num, labels, valid and order are identical; boxes and scores agree within
1e-6 relative (the port's float32 sigmoid may differ from XLA's by an
ulp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import random_heads
from yolort_tpu.models.head import DEFAULT_ANCHOR_GRIDS, DEFAULT_STRIDES
from yolort_tpu.ops import nms as JN
from yolort_tpu_torch.ops import nms as TN
from yolort_tpu_torch.ops.cuda import fused_cells_stage1

GRIDS = [(16, 20), (8, 10), (4, 5)]
CONFIGS = {"serving": dict(score_thresh=0.25, pre_nms_topk=512),
           "eval": dict(score_thresh=0.005, pre_nms_topk=4096)}


def run_both(heads, cfg, d=300):
    kw = dict(num_classes=80, nms_thresh=0.45, detections_per_img=d, **cfg)
    want = jax.jit(lambda hs: JN.batched_postprocess_from_heads(
        hs, DEFAULT_STRIDES, DEFAULT_ANCHOR_GRIDS,
        flatten_pad="cell", topk_impl="bisect", row_gather="pallas_bisect", nms_impl="xla", **kw,
    ))([jnp.asarray(h) for h in heads])
    got = TN.batched_postprocess_from_heads(
        [torch.from_numpy(h) for h in heads], DEFAULT_STRIDES, DEFAULT_ANCHOR_GRIDS, **kw)
    return got, want


def assert_same_detections(got, want):
    np.testing.assert_array_equal(got.num.numpy(), np.asarray(want.num))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("seed,shift", [(0, 1.0), (1, 2.5)])
def test_postprocess_matches_jax_cell_path(config, seed, shift):
    heads = random_heads(seed, GRIDS, batch=2, shift=shift)
    got, want = run_both(heads, CONFIGS[config])
    assert got.boxes.shape == (2, 300, 4) and got.labels.dtype == torch.int32
    cands = (1 / (1 + np.exp(-np.concatenate([h.reshape(2, -1, 85) for h in heads], 1)[..., 4:5]))
             / (1 + np.exp(-np.concatenate([h.reshape(2, -1, 85) for h in heads], 1)[..., 5:])))
    assert ((cands > CONFIGS[config]["score_thresh"]).sum((1, 2)) >= 200).all()  # hundreds of pairs
    assert (got.num.numpy() > 0).all()
    assert_same_detections(got, want)


def test_postprocess_no_candidates():
    heads = random_heads(2, GRIDS, batch=2, shift=-30.0)
    got, want = run_both(heads, CONFIGS["serving"])
    assert not got.num.any() and not got.valid.any()
    assert_same_detections(got, want)


def test_stage1_per_anchor_matches_jax():
    rows = np.random.default_rng(5).standard_normal((2, 30, 255)).astype(np.float32) * 4
    rows[0, 0, 4] = -2e4  # below the JAX reductions' -1e4 floor
    want = np.asarray(JN._stage1_per_anchor(jnp.asarray(rows), 3, 85))
    # the port's stage 1: the maxima of fused_cells_stage1, then their scores
    _, obj, cls = fused_cells_stage1([torch.from_numpy(rows)], 3, 85)
    got = TN._stage1_scores(obj, cls)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
