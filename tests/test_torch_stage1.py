"""The stage-1 screen and the postprocess routes: port against JAX.

``fused_cells_stage1_reference`` (the plain version of the port's kernel)
against the Pallas ``fused_cells_stage1`` in interpret mode, at the level
geometries of ``tests/test_s1_fused.py``: the cells table bit-identical,
the maxima bit-identical to a numpy masked max, and the scores within 2
ulp in float32 (torch's and XLA's sigmoids differ by up to 2 ulp) and 2
ulp in bfloat16 (measured: 2 on about half the scores; XLA's bfloat16
sigmoid rounds its steps, torch's rounds once).  Then the whole postprocess,
whose stage 1 is the fused one, on each ``row_gather`` route against the
JAX program on that route (beside one of the JAX package's three stage-1
routes), and the port's routes against each other, bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolort_tpu_torch
from yolort_tpu.ops import nms as JN
from yolort_tpu.ops.pallas.s1_kernel import fused_cells_stage1 as jax_fused
from yolort_tpu_torch.ops import nms as TN
from yolort_tpu_torch.ops.cuda import fused_cells_stage1, fused_cells_stage1_reference

GEOMETRIES = [  # (grids, A, kw), as tests/test_s1_fused.py
    ([(8, 8), (4, 4), (2, 2)], 3, 12),
    ([(12, 8), (6, 4), (3, 2)], 3, 10),
    ([(16, 16), (8, 8), (4, 4), (2, 2)], 3, 9),
    ([(4, 4)], 2, 8),
    ([(8, 8), (4, 4), (2, 2)], 2, 7),
]
# (JAX s1_impl, row_gather): each stage-2 route of the port beside one
# stage-1 route of the JAX package, so each of those is held against the
# port's one stage 1
JAX_ROUTES = [("cells", "pallas_bisect"), ("fused", "pallas_lookup"), ("precat", "pallas_full")]
STRIDES = (8, 16, 32)
ANCHORS = ((10.0, 13.0, 16.0, 30.0, 33.0, 23.0), (30.0, 61.0, 62.0, 45.0, 59.0, 119.0),
           (116.0, 90.0, 156.0, 198.0, 373.0, 326.0))


def _levels(grids, a, kw, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(0.0, 2.5, (batch, h * w, a * kw)).astype(np.float32) for h, w in grids]


def _numpy_maxima(cells, a, kw):
    """Masked maxima as the JAX reductions take them: NaN propagates, -1e4 floor."""
    x = cells.reshape(*cells.shape[:2], a, kw).astype(np.float32)
    cls = x[..., 5:].max(-1)  # numpy max propagates NaN
    return np.maximum(x[..., 4], np.float32(-1e4)), np.maximum(cls, np.float32(-1e4))


def _ulp_f32(a, b):
    ia, ib = a.view(np.int32).astype(np.int64), b.view(np.int32).astype(np.int64)
    return np.abs(ia - ib).max()


@pytest.mark.parametrize("grids,a,kw", GEOMETRIES)
def test_fused_reference_matches_jax_kernel(grids, a, kw):
    levels = _levels(grids, a, kw)
    jcells, jper = jax_fused([jnp.asarray(lv) for lv in levels], a, kw, interpret=True)
    cells, obj, cls = fused_cells_stage1([torch.from_numpy(lv) for lv in levels], a, kw)
    np.testing.assert_array_equal(cells.numpy().view(np.int32), np.asarray(jcells).view(np.int32))
    want_obj, want_cls = _numpy_maxima(np.concatenate(levels, 1), a, kw)
    np.testing.assert_array_equal(obj.numpy(), want_obj)
    np.testing.assert_array_equal(cls.numpy(), want_cls)
    per = TN._stage1_scores(obj, cls).reshape(2, -1).numpy()
    assert per.shape == np.asarray(jper).shape
    assert _ulp_f32(per, np.asarray(jper)) <= 2


def test_fused_reference_bf16_matches_jax_kernel():
    levels = [jnp.asarray(lv).astype(jnp.bfloat16) for lv in _levels([(8, 8), (4, 4), (2, 2)], 3, 12, 1)]
    jcells, jper = jax_fused(levels, 3, 12, interpret=True)
    tl = [torch.from_numpy(np.array(jax.lax.bitcast_convert_type(lv, jnp.int16))).view(torch.bfloat16)
          for lv in levels]
    cells, obj, cls = fused_cells_stage1(tl, 3, 12)
    assert cells.dtype == obj.dtype == cls.dtype == torch.bfloat16
    np.testing.assert_array_equal(cells.view(torch.int16).numpy(),
                                  np.asarray(jax.lax.bitcast_convert_type(jcells, jnp.int16)))
    per = TN._stage1_scores(obj, cls).reshape(2, -1).view(torch.int16).numpy().astype(np.int64)
    jbits = np.asarray(jax.lax.bitcast_convert_type(jper, jnp.int16)).astype(np.int64)
    assert np.abs(per - jbits).max() <= 2  # bfloat16 ulps (positive scores)


def test_fused_reference_special_logits():
    """NaN propagates through both maxima, +-inf pass, logits below -1e4
    take the floor; the cells table keeps every bit."""
    a, kw = 3, 12
    levels = _levels([(4, 4), (2, 2)], a, kw, seed=2)
    lv = levels[0]
    lv[0, 0, 4] = np.nan           # obj of anchor 0
    lv[0, 1, kw + 7] = np.nan      # a class of anchor 1
    lv[0, 2, 4], lv[0, 2, 5] = np.inf, -np.inf
    lv[0, 3, 5:kw] = -np.inf       # every class of anchor 0 below the floor
    lv[1, 4, 2 * kw + 4] = -3e4
    lv[1, 5, kw + 5:2 * kw] = -2e4
    jcells, jper = jax_fused([jnp.asarray(x) for x in levels], a, kw, interpret=True)
    cells, obj, cls = fused_cells_stage1([torch.from_numpy(x) for x in levels], a, kw)
    np.testing.assert_array_equal(cells.numpy().view(np.int32), np.asarray(jcells).view(np.int32))
    want_obj, want_cls = _numpy_maxima(np.concatenate(levels, 1), a, kw)
    np.testing.assert_array_equal(obj.numpy(), want_obj)  # NaN positions compare equal
    np.testing.assert_array_equal(cls.numpy(), want_cls)
    assert np.isnan(obj[0, 0, 0].item()) and np.isnan(cls[0, 1, 1].item())
    assert obj[0, 2, 0] == np.inf and cls[0, 3, 0] == -1e4 and obj[1, 4, 2] == -1e4
    per = TN._stage1_scores(obj, cls).reshape(2, -1).numpy()
    jp = np.asarray(jper)
    np.testing.assert_array_equal(np.isnan(per), np.isnan(jp))
    fin = ~np.isnan(per)
    assert _ulp_f32(per[fin], jp[fin]) <= 2


def test_fused_reference_equals_plain_concat_and_maxima():
    levels = [torch.from_numpy(x) for x in _levels([(6, 5), (3, 3)], 3, 85, seed=3)]
    cells, obj, cls = fused_cells_stage1_reference(levels, 3, 85)
    assert torch.equal(cells, torch.cat(levels, 1))
    x = cells.unflatten(-1, (3, 85))
    ref = torch.sigmoid(x[..., 5:].amax(-1).clamp_min(-1e4)) * torch.sigmoid(x[..., 4].clamp_min(-1e4))
    assert torch.equal(TN._stage1_scores(obj, cls), ref)


def _heads(seed, grids=((8, 8), (4, 4), (2, 2)), batch=2):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((batch, h, w, 3 * 85)) * 2.0 - 2.0).astype(np.float32) for h, w in grids]


ROUTE_CONFIGS = {
    "lookup_kernel_test": dict(score_thresh=0.05, detections_per_img=30, pre_nms_topk=128),
    "eval": dict(score_thresh=0.005, detections_per_img=300, pre_nms_topk=4096),
}


@pytest.mark.parametrize("config", sorted(ROUTE_CONFIGS))
@pytest.mark.parametrize("s1_impl,row_gather", JAX_ROUTES)
def test_postprocess_route_matches_jax(s1_impl, row_gather, config):
    """The JAX cell path on the same row_gather route and the stage 1
    ``s1_impl`` (its Pallas kernels in interpret mode, XLA NMS) against the
    port's, at the geometry of tests/test_lookup_kernel.py:173-201."""
    heads = _heads(13)
    kw = dict(num_classes=80, nms_thresh=0.45, **ROUTE_CONFIGS[config])
    want = jax.jit(lambda hs: JN.batched_postprocess_from_heads(
        hs, STRIDES, ANCHORS, flatten_pad="cell", topk_impl="bisect", nms_impl="xla",
        s1_impl=s1_impl, row_gather=row_gather, **kw,
    ))([jnp.asarray(h) for h in heads])
    got = TN.batched_postprocess_from_heads([torch.from_numpy(h) for h in heads], STRIDES, ANCHORS,
                                            row_gather=row_gather, **kw)
    assert (got.num.numpy() > 0).all()
    np.testing.assert_array_equal(got.num.numpy(), np.asarray(want.num))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("config", sorted(ROUTE_CONFIGS))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("row_gather", ["pallas_lookup", "pallas_full"])
def test_port_routes_equal_the_default_route(row_gather, dtype, config):
    heads = [torch.from_numpy(h + 2.5).to(dtype) for h in _heads(21, ((16, 20), (8, 10), (4, 5)))]
    cfg = ROUTE_CONFIGS[config]
    base = TN.batched_postprocess_from_heads(heads, STRIDES, ANCHORS, num_classes=80, **cfg)
    got = TN.batched_postprocess_from_heads(heads, STRIDES, ANCHORS, num_classes=80,
                                            row_gather=row_gather, **cfg)
    assert (base.num > 0).all()
    for a, b in zip(got, base):
        assert torch.equal(a, b)


def test_yolov5n_fused_lookup_route_equals_default():
    rng = np.random.default_rng(4)
    frames = [rng.integers(0, 256, (90, 120, 3), dtype=np.uint8) for _ in range(2)]
    kw = dict(device="cpu", size=(128, 128), score_thresh=0.0, pre_nms_topk=256, seed=1)
    base = yolort_tpu_torch.yolov5n(**kw)
    routed = yolort_tpu_torch.yolov5n(row_gather="pallas_lookup", **kw)
    assert routed.model.row_gather == "pallas_lookup"
    for a, b in zip(routed(frames), base(frames)):
        assert len(a["boxes"]) > 0
        for key in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(a[key], b[key])
