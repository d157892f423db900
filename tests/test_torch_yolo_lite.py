"""yolo_lite (``yolov5_mobilenet_v3_small_fpn``: MobileNetV3-Small, an FPN
with a max-pool extra level, four levels at strides 8-64) in the port
against the JAX package, float32 on the CPU.

- 5 classes, params of JAX's ``init`` layout (the backbone's drawn with
  numpy), random
  BatchNorm statistics and every other conv folded, carried across: head outputs within atol 1e-4
  (tests/test_torch_families.py) at 128x128 and at 240x320, whose
  stride-16 level is odd (15x20 -> the top-down resize from 8x10 is not
  an exact 2x, and the extra level of 4x5 is ceil(8/2) x ceil(10/2)).
- Detections of identical 4-level logits equal to the JAX cell path's
  (``topk_impl='bisect'``) in the eval and serving configs: count, valid,
  labels and order exactly, scores and boxes within rtol 1e-6.
- The ``Detector`` surface: ``with_thresholds``, ``YOLOv5(model=...)``
  with stride-64 rounding, and the factory's ``pretrained=True`` raising.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_zoo_blocks import numpy_params
from torch_parity import random_heads, randomize_convs
from yolort_tpu.models.yolo_lite import yolov5_mobilenet_v3_small_fpn as jax_lite
from yolort_tpu.ops import nms as JN
from yolort_tpu_torch import yolov5_mobilenet_v3_small_fpn
from yolort_tpu_torch.models import YOLOv5
from yolort_tpu_torch.models._bridge import params_from_jax

NC = 5


def numpy_init(jm, seed: int):
    """``jm.init``'s tree, the backbone's drawn with numpy, the head's own
    init (it computes its prior bias in numpy)."""
    kb, kh = jax.random.split(jax.random.PRNGKey(seed))
    return {"backbone": numpy_params(jm.backbone.init, seed), "head": jm.head.init(kh)}


@pytest.fixture(scope="module")
def pair():
    jm = jax_lite(num_classes=NC)
    params = randomize_convs(numpy_init(jm, 0), 0)
    tm = params_from_jax(params, yolov5_mobilenet_v3_small_fpn(num_classes=NC, device="cpu"))
    return jm, params, tm


@pytest.mark.parametrize("hw", [(128, 128), (240, 320)])
def test_head_outputs_match_jax(pair, hw):
    jm, params, tm = pair
    x = np.random.default_rng(1).random((2, *hw, 3)).astype(np.float32)
    want = jax.jit(jm.head_outputs)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm.head_outputs(torch.from_numpy(x))
    h, w = hw
    assert [tuple(g.shape[1:3]) for g in got] == [
        (-(-h // s), -(-w // s)) for s in (8, 16, 32, 64)]
    for g, wt in zip(got, want):
        assert g.shape == wt.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), atol=1e-4, rtol=0)


CONFIGS = {
    "eval": dict(score_thresh=0.005, pre_nms_topk=4096),
    "serving": dict(score_thresh=0.25, pre_nms_topk=512),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_detections_match_jax(pair, config):
    jm, _, tm = pair
    grids = ((30, 40), (15, 20), (8, 10), (4, 5))
    heads = random_heads(53, grids, nc=NC, shift=-1.0)
    model = tm.with_thresholds(**CONFIGS[config])
    want = jax.jit(lambda hs: JN.batched_postprocess_from_heads(
        hs, jm.strides, jm.anchor_grids, num_classes=NC, nms_thresh=0.45,
        detections_per_img=300, flatten_pad="cell", topk_impl="bisect",
        row_gather="pallas_bisect", nms_impl="xla", **CONFIGS[config],
    ))([jnp.asarray(h) for h in heads])
    got = model.postprocess([torch.from_numpy(h) for h in heads])
    assert model.strides == jm.strides and model.anchor_grids == jm.anchor_grids
    assert (got.num.numpy() > 0).all()
    np.testing.assert_array_equal(got.num.numpy(), np.asarray(want.num))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-6, atol=1e-5)


def test_serves_through_yolov5_with_thresholds(pair):
    _, _, tm = pair
    loose = tm.with_thresholds(score_thresh=0.0, detections_per_img=40)
    assert tm.score_thresh == 0.005 and loose.backbone is tm.backbone
    frames = list(np.random.default_rng(3).integers(0, 256, (2, 100, 150, 3), dtype=np.uint8))
    m = YOLOv5(model=loose, size=(128, 128), size_divisible=64)
    canvas = m.canvas(torch.from_numpy(np.stack(frames)))[0]
    assert tuple(canvas.shape[1:3]) == (128, 128)
    out = m(frames)
    assert [len(d["scores"]) for d in out] == [40, 40]
    assert all((d["labels"] < NC).all() for d in out)
    with pytest.raises(NotImplementedError):
        yolov5_mobilenet_v3_small_fpn(pretrained=True, device="cpu")
