"""Greedy NMS: the port's plain version, and ``nms_keep_mask`` on CPU
tensors, against the JAX ``greedy_nms_mask`` (the oracle of the JAX Pallas
kernel, which has no interpret mode), bit for bit, with and without the
``stop_after`` early exit; the box ops bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolort_tpu.ops import nms as JN
from yolort_tpu_torch.ops import boxes as TB
from yolort_tpu_torch.ops import nms as TN
from yolort_tpu_torch.ops.cuda import nms_mask, nms_mask_reference


def candidates(seed, bsz, k, n_valid, classes=4):
    """Score-sorted, class-offset boxes with a valid prefix."""
    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0, 300, (bsz, k, 2))
    wh = rng.uniform(5, 150, (bsz, k, 2))
    boxes = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0, 320).astype(np.float32)
    labels = rng.integers(0, classes, (bsz, k)).astype(np.float32)
    boxes = boxes + (labels * 321.0)[..., None]
    valid = np.zeros((bsz, k), bool)
    valid[:, :n_valid] = True
    return boxes, valid


def jax_masks(boxes, valid, thr, tile, stop_after):
    fn = jax.jit(lambda b, v: JN.greedy_nms_mask(b, v, thr, tile_size=tile, stop_after=stop_after))
    return np.stack([np.asarray(fn(jnp.asarray(b), jnp.asarray(v))) for b, v in zip(boxes, valid)])


@pytest.mark.parametrize("k,n_valid", [(512, 358), (1024, 700), (300, 300)])
@pytest.mark.parametrize("stop_after", [0, 30])
def test_nms_mask_reference_matches_jax_greedy(k, n_valid, stop_after):
    boxes, valid = candidates(k + stop_after, 2, k, n_valid)
    want = jax_masks(boxes, valid, 0.45, 256, stop_after)
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    got = nms_mask_reference(tb, tv, 0.45, tile_size=256, stop_after=stop_after)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(TN.nms_keep_mask(tb, tv, 0.45, 256, stop_after).numpy(), want)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(nms_mask(tb, tv, 0.45, 256, stop_after).numpy(), want)
    if stop_after == 0:  # suppression work happened
        assert want.sum() < valid.sum()


@pytest.mark.parametrize("stop_after", [300, 0])
def test_nms_keep_mask_matches_jax_past_16384_candidates(stop_after):
    """K = 16448, past the 16384 the card once refused and not a multiple
    of the tile (the JAX package takes its XLA greedy_nms_mask there): the
    port's nms_keep_mask on CPU tensors against it, the whole mask."""
    k, n_valid = 16448, 700
    boxes, valid = candidates(k + stop_after, 1, k, n_valid)
    want = jax_masks(boxes, valid, 0.45, 256, stop_after)
    got = TN.nms_keep_mask(torch.from_numpy(boxes), torch.from_numpy(valid), 0.45, 256, stop_after)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < n_valid


def test_nms_all_invalid_and_all_overlapping():
    boxes = np.tile(np.asarray([[10, 10, 50, 50]], np.float32), (1, 256, 1))
    valid = np.ones((1, 256), bool)
    got = nms_mask_reference(torch.from_numpy(boxes), torch.from_numpy(valid), 0.45)
    assert got.sum() == 1 and bool(got[0, 0])
    got = nms_mask_reference(torch.from_numpy(boxes), torch.zeros(1, 256, dtype=torch.bool), 0.45)
    assert not got.any()


def test_box_ops_bit_identical():
    rng = np.random.default_rng(3)
    a = (rng.random((40, 4)) * 100).astype(np.float32)
    a[:, 2:] += a[:, :2]
    b = (rng.random((30, 4)) * 100).astype(np.float32)
    b[:, 2:] += b[:, :2]
    want = np.asarray(JN.box_iou_matrix(jnp.asarray(a), jnp.asarray(b)))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(TB.box_iou_matrix(ta, tb).numpy(), want)
    # a leading batch dimension broadcasts
    np.testing.assert_array_equal(TB.box_iou_matrix(ta[None], tb[None])[0].numpy(), want)
    np.testing.assert_array_equal(TB.box_area(ta).numpy(), np.asarray(JN.box_area(jnp.asarray(a))))
    np.testing.assert_array_equal(TB.cxcywh_to_xyxy(ta).numpy(),
                                  np.asarray(JN.cxcywh_to_xyxy(jnp.asarray(a))))


def test_compact_detections_matches_jax():
    rng = np.random.default_rng(4)
    keep = rng.random((2, 64)) < 0.4
    boxes = rng.random((2, 64, 4)).astype(np.float32)
    scores = rng.random((2, 64)).astype(np.float32)
    labels = rng.integers(0, 80, (2, 64)).astype(np.int32)
    got = TN._compact_detections(torch.from_numpy(keep), torch.from_numpy(boxes),
                                 torch.from_numpy(scores), torch.from_numpy(labels), 20)
    for b in range(2):
        want = JN._compact_detections(jnp.asarray(keep[b]), jnp.asarray(boxes[b]), jnp.asarray(scores[b]),
                                      jnp.asarray(labels[b]), 20)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))
