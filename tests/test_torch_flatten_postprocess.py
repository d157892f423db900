"""The flatten-path postprocess (``classes_per_anchor``), the decoded-
prediction postprocess and the unsorted selections against the JAX
package, on the CPU.

- ``select_topk_threshold(sort=False)`` on every ``row_gather`` route and
  ``select_topk_indices_compact`` against JAX's: values bit for bit,
  indices equal, slot for slot (ties, fewer valid than k, none valid, a
  partial last chunk).
- ``batched_postprocess_from_heads(classes_per_anchor=c)`` for c in 1, 4
  and nc, on every route, against JAX's flatten path as an accelerator
  runs it (``topk_impl='bisect'``, ``anchor_arith=True``; ``nms_impl=
  'xla'``, the plain version of the Pallas NMS): count, valid, labels and
  order exactly, scores and boxes within rtol 1e-6 (torch's and XLA's
  sigmoids may differ by 2 ulp; tests/test_torch_stage1.py), plus
  tests/test_classes_per_anchor.py's exactness case and anchors whose
  classes tie exactly (``lax.top_k`` keeps the lower class first).
- ``batched_postprocess`` of decoded predictions against JAX's
  (``topk_impl='bisect'``) on every route, and against the numpy oracle of
  tests/test_nms.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_nms import _reference_postprocess, random_boxes
from torch_parity import random_heads
from yolort_tpu.ops import nms as JN
from yolort_tpu.ops import select as JS
from yolort_tpu_torch.models import head as TH
from yolort_tpu_torch.ops import nms as TN
from yolort_tpu_torch.ops import select as TS

ROUTES = TS.ROW_GATHERS
GRIDS = ((16, 16), (8, 8), (4, 4))
STRIDES = TH.DEFAULT_STRIDES
ANCHORS = TH.DEFAULT_ANCHOR_GRIDS
SERVING = dict(score_thresh=0.25, nms_thresh=0.45, detections_per_img=300, pre_nms_topk=512)


def _scores(seed, shape, kind="sig", valid_frac=1.0):
    rng = np.random.default_rng(seed)
    if kind == "ties":  # few distinct values: many boundary ties
        s = rng.integers(0, 40, shape).astype(np.float32) / 40.0
    else:
        a, c = rng.standard_normal(shape) * 2 - 1, rng.standard_normal(shape) * 2 - 1
        s = ((1 / (1 + np.exp(-a))) * (1 / (1 + np.exp(-c)))).astype(np.float32)
    s[:, int(s.shape[1] * valid_frac):] = 0.0
    return s


CASES = [  # (kind, valid_frac, k, thresh)
    ("sig", 1.0, 300, 0.25),
    ("ties", 1.0, 257, 0.1),
    ("sig", 0.01, 500, 0.25),   # fewer valid entries than k
    ("sig", 1.0, 64, 0.999),    # none valid
]


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("kind,frac,k,thr", CASES)
def test_unsorted_select_and_compact_indices_match_jax(kind, frac, k, thr, route):
    s = _scores(3, (2, 1111), kind, frac)  # 1111: a partial last chunk
    vals, idx = TS.select_topk_threshold(torch.from_numpy(s), k, thr, row_gather=route,
                                         sort=False)
    ok, cidx = TS.select_topk_indices_compact(torch.from_numpy(s), k, thr, row_gather=route)
    fn = jax.jit(lambda x: JS.select_topk_threshold(x, k, thr, sort=False))
    fc = jax.jit(lambda x: JS.select_topk_indices_compact(x, k, thr))
    for b in range(s.shape[0]):
        jv, ji = fn(jnp.asarray(s[b]))
        np.testing.assert_array_equal(vals[b].numpy().view(np.int32), np.asarray(jv).view(np.int32))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
        jok, jidx = fc(jnp.asarray(s[b]))
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(jok))
        np.testing.assert_array_equal(cidx[b].numpy(), np.asarray(jidx))
    # the unsorted order: every strictly-above entry before the ties, each
    # tier in index order
    if kind == "ties":
        v = vals[0].numpy()
        n = int((v >= 0).sum())
        t = v[:n].min()
        above = v[:n] > t
        assert not (above[1:] & ~above[:-1]).any()
        assert (np.diff(idx[0].numpy()[:n][above]) > 0).all()
        assert (np.diff(idx[0].numpy()[:n][~above]) > 0).all()


def _jax_heads(heads, cpa, dtype=jnp.float32, **cfg):
    return jax.jit(lambda hs: JN.batched_postprocess_from_heads(
        hs, STRIDES, ANCHORS, num_classes=hs[0].shape[-1] // 3 - 5, topk_impl="bisect",
        anchor_arith=True, nms_impl="xla", classes_per_anchor=cpa, **cfg,
    ))([jnp.asarray(h, dtype) for h in heads])


def _same_detections(got, want, rtol=1e-6):
    np.testing.assert_array_equal(got.num.numpy(), np.asarray(want.num))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores, np.float32),
                               rtol=rtol, atol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes, np.float32), rtol=rtol,
                               atol=1e-5)


@pytest.fixture(scope="module")
def cpa_heads():
    heads = random_heads(41, GRIDS, shift=-1.0)
    want = {cpa: _jax_heads(heads, cpa, **SERVING) for cpa in (1, 4, 80)}
    return heads, want


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("cpa", [1, 4, 80])
def test_classes_per_anchor_detections_match_jax_on_every_route(cpa_heads, cpa, route):
    heads, want = cpa_heads
    got = TN.batched_postprocess_from_heads([torch.from_numpy(h) for h in heads], STRIDES, ANCHORS,
                                            num_classes=80, classes_per_anchor=cpa,
                                            row_gather=route, **SERVING)
    assert (got.num.numpy() > 20).all()
    _same_detections(got, want[cpa])


def test_classes_per_anchor_at_num_classes_equals_the_exact_path(cpa_heads):
    """c >= nc is exact multi-label semantics: the flatten path gives the
    cell path's detections."""
    heads, _ = cpa_heads
    hs = [torch.from_numpy(h) for h in heads]
    cell = TN.batched_postprocess_from_heads(hs, STRIDES, ANCHORS, num_classes=80, **SERVING)
    for cpa in (80, 500):
        flat = TN.batched_postprocess_from_heads(hs, STRIDES, ANCHORS, num_classes=80,
                                                 classes_per_anchor=cpa, **SERVING)
        assert all(torch.equal(a, b) for a, b in zip(flat, cell))


def test_classes_per_anchor_in_bfloat16_matches_jax():
    """bf16 head logits: the stage-1 scores in bf16 on both sides, stage 2
    in f32."""
    heads = [h.astype(np.float32) for h in random_heads(43, GRIDS, batch=1, shift=-1.0)]
    tb = [torch.from_numpy(h).to(torch.bfloat16) for h in heads]
    want = _jax_heads([np.asarray(t.float()) for t in tb], 4, jnp.bfloat16, **SERVING)
    got = TN.batched_postprocess_from_heads(tb, STRIDES, ANCHORS, num_classes=80,
                                            classes_per_anchor=4, **SERVING)
    assert int(got.num[0]) > 0
    _same_detections(got, want)


def _hot_heads(seed, b=1, hw=(8, 8), nc=20, na=3, hot_classes=2):
    """tests/test_classes_per_anchor.py's heads: each anchor has a few
    clearly-above-threshold classes and the rest far below."""
    rng = np.random.default_rng(seed)
    h, w = hw
    k = 5 + nc
    logits = rng.normal(-8.0, 0.5, (b, h, w, na * k)).astype(np.float32)
    lv = logits.reshape(b, h, w, na, k)
    lv[..., 0:4] = rng.normal(0, 1, lv[..., 0:4].shape)
    lv[..., 4] = rng.normal(2.0, 0.5, lv[..., 4].shape)
    for bi in range(b):
        for yy in range(h):
            for xx in range(w):
                for ai in range(na):
                    hot = rng.choice(nc, hot_classes, replace=False)
                    lv[bi, yy, xx, ai, 5 + hot] = rng.normal(2.0, 0.5, hot_classes)
    return [logits]


HOT = dict(num_classes=20, score_thresh=0.05, nms_thresh=0.45, detections_per_img=100,
           pre_nms_topk=256, nms_tile_size=64)


def test_classes_per_anchor_exact_when_few_hot_classes():
    heads = _hot_heads(0)
    hs = [torch.from_numpy(h) for h in heads]
    exact = TN.batched_postprocess_from_heads(hs, (8,), [ANCHORS[0]], **HOT)
    cut = TN.batched_postprocess_from_heads(hs, (8,), [ANCHORS[0]], classes_per_anchor=4, **HOT)
    assert int(exact.num[0]) > 0
    np.testing.assert_array_equal(exact.num.numpy(), cut.num.numpy())
    np.testing.assert_array_equal(exact.labels.numpy(), cut.labels.numpy())
    np.testing.assert_allclose(exact.boxes.numpy(), cut.boxes.numpy(), atol=1e-5)
    np.testing.assert_allclose(exact.scores.numpy(), cut.scores.numpy(), atol=1e-6)
    want = jax.jit(lambda h: JN.batched_postprocess_from_heads(
        h, (8,), [ANCHORS[0]], topk_impl="bisect", anchor_arith=True, nms_impl="xla",
        classes_per_anchor=4, **HOT))([jnp.asarray(heads[0])])
    _same_detections(cut, want)


@pytest.mark.parametrize("route", ROUTES)
def test_classes_per_anchor_tied_classes_keep_the_lower_class(route):
    """Anchors whose hot classes carry the same logit: their scores tie
    exactly, and the cut keeps the lowest classes of a tie, as lax.top_k
    does (a sort without a stable tie order would pick others)."""
    heads = _hot_heads(5, nc=20, hot_classes=2)
    lv = heads[0].reshape(1, 8, 8, 3, 25)
    rng = np.random.default_rng(6)
    for yy in range(8):
        for xx in range(8):
            lv[0, yy, xx, :, 5 + rng.choice(20, 6, replace=False)] = 1.5  # six tied classes
    want = jax.jit(lambda h: JN.batched_postprocess_from_heads(
        h, (8,), [ANCHORS[0]], topk_impl="bisect", anchor_arith=True, nms_impl="xla",
        classes_per_anchor=3, **HOT))([jnp.asarray(heads[0])])
    got = TN.batched_postprocess_from_heads([torch.from_numpy(heads[0])], (8,), [ANCHORS[0]],
                                            classes_per_anchor=3, row_gather=route, **HOT)
    assert int(got.num[0]) > 0
    _same_detections(got, want)
    vals, idx = TN.top_classes(torch.tensor([[[0.5, 0.75, 0.5, 0.75, 0.5]]]), 3)
    assert idx.tolist() == [[[1, 3, 0]]] and vals.tolist() == [[[0.75, 0.75, 0.5]]]


def _decoded(seed, b=2, na=500, nc=8):
    """tests/test_nms.py's decoded predictions: random boxes as cxcywh,
    uniform obj and class scores."""
    rng = np.random.default_rng(seed)
    pred = np.zeros((b, na, 5 + nc), np.float32)
    for i in range(b):
        xyxy = random_boxes(rng, na)
        pred[i, :, :4] = np.stack([(xyxy[:, 0] + xyxy[:, 2]) / 2, (xyxy[:, 1] + xyxy[:, 3]) / 2,
                                   xyxy[:, 2] - xyxy[:, 0], xyxy[:, 3] - xyxy[:, 1]], 1)
        pred[i, :, 4] = rng.uniform(0, 1, na)
        pred[i, :, 5:] = rng.uniform(0, 1, (na, nc))
    return pred


DECODED = dict(score_thresh=0.4, nms_thresh=0.5, detections_per_img=100, pre_nms_topk=1024,
               nms_tile_size=128)


@pytest.mark.parametrize("route", ROUTES)
def test_decoded_postprocess_matches_jax_and_the_oracle(route):
    pred = _decoded(100)
    got = TN.batched_postprocess(torch.from_numpy(pred), num_classes=8, row_gather=route, **DECODED)
    want = jax.jit(lambda p: JN.batched_postprocess(p, num_classes=8, topk_impl="bisect",
                                                    nms_impl="xla", **DECODED))(jnp.asarray(pred))
    _same_detections(got, want, rtol=0)
    for b in range(2):
        rb, rs, rl = _reference_postprocess(pred[b], 8, 0.4, 0.5, 100)
        n = int(got.num[b])
        assert n == len(rb) > 0
        np.testing.assert_allclose(got.scores[b, :n].numpy(), rs, rtol=1e-5)
        np.testing.assert_array_equal(got.labels[b, :n].numpy(), rl)
        np.testing.assert_allclose(got.boxes[b, :n].numpy(), rb, rtol=1e-5)
        assert not got.valid[b, n:].any()


def test_decoded_postprocess_of_a_model_and_empty_predictions():
    """``YOLO.decode`` into ``batched_postprocess`` against JAX's on the same
    decoded tensor (anchors of three levels, 80 classes), and all-zero
    predictions give no detection."""
    heads = random_heads(47, GRIDS, shift=-1.0)
    pred = TH.concat_pred_logits([torch.from_numpy(h) for h in heads], GRIDS, STRIDES, ANCHORS)
    kw = dict(SERVING, nms_tile_size=256)
    got = TN.batched_postprocess(pred, num_classes=80, **kw)
    want = jax.jit(lambda p: JN.batched_postprocess(p, num_classes=80, topk_impl="bisect",
                                                    nms_impl="xla", **kw))(jnp.asarray(pred.numpy()))
    assert (got.num.numpy() > 20).all()
    _same_detections(got, want, rtol=0)
    empty = TN.batched_postprocess(torch.zeros(1, 100, 9), num_classes=4, score_thresh=0.25,
                                   detections_per_img=10, pre_nms_topk=64)
    assert int(empty.num[0]) == 0 and not empty.valid.any()


def test_flatten_heads_and_anchor_tables_match_jax():
    from yolort_tpu.models import head as JH

    heads = random_heads(48, GRIDS, batch=1)
    got = TH.flatten_heads([torch.from_numpy(h) for h in heads], 3)
    want = JH.flatten_heads([jnp.asarray(h) for h in heads], 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w in zip(TH.anchor_tables(GRIDS, STRIDES, ANCHORS),
                    JH.anchor_tables(GRIDS, STRIDES, ANCHORS)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    idx = torch.arange(got.shape[1])
    for g, t in zip(TH.anchor_props_from_index(idx, GRIDS, STRIDES, ANCHORS),
                    TH.anchor_tables(GRIDS, STRIDES, ANCHORS)):
        assert torch.equal(g, t)
