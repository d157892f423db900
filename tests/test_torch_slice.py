"""The slice end to end on the CPU: the port's ``YOLOv5.__call__`` on two
requests of different raw sizes against the JAX pipeline composed as
``YOLOv5._infer`` composes it, on the cell path.

Same weights (bridged), same float images.  Detections are matched by
label with boxes within 1e-3 px: the networks agree to ~1e-5 in f32, so
near-equal scores may swap places but every detection must have its
counterpart."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import tiny_pair
from yolort_tpu.models import transform as JT
from yolort_tpu.ops import nms as JN
from yolort_tpu_torch.models.yolov5 import YOLOv5

SIZE = 128
SHAPES = [(100, 130), (90, 60)]


def jax_infer(jm, params, raw):
    b, h, w, _ = raw.shape
    plan = JT.make_plan([(h, w)], SIZE, SIZE, 32)[0]

    @jax.jit
    def infer(params, raw):
        canvas = JT.letterbox_batch(raw, plan, 114 / 255.0)
        outs = jm.head_outputs(params, canvas)
        det = JN.batched_postprocess_from_heads(
            outs, jm.strides, jm.anchor_grids, num_classes=jm.num_classes,
            score_thresh=jm.score_thresh, nms_thresh=jm.nms_thresh,
            detections_per_img=jm.detections_per_img, pre_nms_topk=jm.pre_nms_topk,
            flatten_pad="cell", topk_impl="bisect", row_gather="pallas_bisect", nms_impl="xla",
        )
        boxes = JT.scale_coords_back(det.boxes, plan.canvas_hw, jnp.asarray([h, w], jnp.float32))
        return det, boxes

    det, boxes = infer(params, jnp.asarray(raw))
    return [{"boxes": np.asarray(boxes[i][:n]), "scores": np.asarray(det.scores[i][:n]),
             "labels": np.asarray(det.labels[i][:n])}
            for i, n in enumerate(np.asarray(det.num))]


@pytest.mark.parametrize("config", [dict(score_thresh=0.25, pre_nms_topk=512)])
def test_yolov5_call_matches_jax(config):
    jm, params, tm = tiny_pair(seed=3, head_shift=7.0, **config)
    model = YOLOv5(model=tm, device="cpu", size=(SIZE, SIZE))
    rng = np.random.default_rng(0)
    images = [rng.random((*SHAPES[i % 2], 3)).astype(np.float32) for i in range(3)]
    got = model(images)
    want = [None] * len(images)
    for shape in SHAPES:
        idx = [i for i, im in enumerate(images) if im.shape[:2] == shape]
        for i, d in zip(idx, jax_infer(jm, params, np.stack([images[i] for i in idx]))):
            want[i] = d
    for g, w in zip(got, want):
        assert len(w["boxes"]) > 0
        assert len(g["boxes"]) == len(w["boxes"])
        assert g["labels"].dtype == np.int64 and g["boxes"].dtype == np.float32
        unmatched = []
        for box, label in zip(w["boxes"], w["labels"]):
            close = (g["labels"] == label) & (np.abs(g["boxes"] - box).max(-1) <= 1e-3)
            if not close.any():
                unmatched.append((box, label))
        assert not unmatched, unmatched[:3]


def test_predict_takes_arrays_and_uint8():
    _, _, tm = tiny_pair(seed=4, head_shift=7.0, score_thresh=0.25, pre_nms_topk=64)
    model = YOLOv5(model=tm, device="cpu", size=(SIZE, SIZE))
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, (70, 90, 3), dtype=np.uint8)
    one = model.predict(u8)
    same = model.predict([u8.astype(np.float32) / 255.0])
    assert len(one) == 1 and len(one[0]["boxes"]) > 0
    np.testing.assert_allclose(one[0]["boxes"], same[0]["boxes"], atol=1e-3)
    with pytest.raises(ValueError):
        model([np.zeros((4, 4), np.float32)])
