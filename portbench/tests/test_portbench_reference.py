"""The plain reference against the program at a small size on the CPU:
the same frames and weights through ``yolort_tpu_torch``'s
``YOLOv5.__call__`` and through ``portbench.reference``, the same
detections within float32 rounding."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from portbench import frames, judge, program, weights
from portbench.reference import models as ref_models, pipeline

CFG = {"nc": 6, "depth_multiple": 0.33, "width_multiple": 0.25, "p6": False, "version": "r6.0",
       "anchors": [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119], [116, 90, 156, 198, 373, 326]],
       "strides": [8, 16, 32], "dtype": "float32", "size": [96, 96], "size_divisible": 32,
       "row_gather": "pallas_bisect", "assumed": {"class_bias_noise": 1.0, "candidates_above_0.25": 120}}
P6 = {"p6": True, "strides": [8, 16, 32, 64], "size": [128, 128], "size_divisible": 64,
      "anchors": [[19, 27, 44, 40, 38, 94], [96, 68, 86, 152, 180, 137],
                  [140, 301, 303, 264, 238, 542], [436, 615, 739, 380, 925, 792]]}
EVAL = {"score_thresh": 0.005, "nms_thresh": 0.45, "pre_nms_topk": 256, "detections_per_img": 40}
SERVE = {"score_thresh": 0.25, "nms_thresh": 0.45, "pre_nms_topk": 64, "detections_per_img": 40}


def _setup(tmp_path, cfg, traffic, seed):
    pool = frames.make_pool(traffic, seed, "cpu")
    fixed = traffic.get("fixed_shape")
    net = ref_models.build(cfg["p6"], cfg["nc"], cfg["depth_multiple"], cfg["width_multiple"],
                           cfg["anchors"])
    flat = [torch.from_numpy(f) for req in pool for f in req]
    plans = [pipeline.plan(tuple(f.shape[:2]), tuple(cfg["size"]), cfg["size_divisible"], fixed)
             for f in flat]
    x = torch.stack([pipeline.letterbox(f, p) for f, p in zip(flat, plans) if p.canvas == plans[0].canvas])
    weights.make(net, seed, x, flat, cfg, fixed)
    path = os.path.join(tmp_path, "w.pt")
    ref_models.save_checkpoint(net, path)
    return pool, net, program.build(path, cfg, traffic, "cpu")


@pytest.mark.parametrize("case", ["p5-eval", "p5-serve", "p6-serve", "p5-mixed"])
def test_reference_matches_program(tmp_path, case):
    cfg = dict(CFG, **(P6 if case.startswith("p6") else {}))
    traffic = {"batch": 3, "pool": 1, "post": EVAL if "eval" in case or "mixed" in case else SERVE,
               "sizes": [[72, 96]] if case.startswith("p5") else [[72, 128]]}
    if case == "p5-mixed":
        traffic.update(sizes=[[72, 96], [96, 64], [50, 96]], fixed_shape=[96, 96])
    pool, net, m = _setup(tmp_path, cfg, traffic, seed=2 ** 33 + 5)
    outs = m(pool[0])
    refs = pipeline.run(net, [torch.from_numpy(f) for f in pool[0]], cfg, traffic["post"],
                        None if "fixed_shape" not in traffic else tuple(traffic["fixed_shape"]))
    got = judge.judge(outs, refs, traffic["post"], 0.02, "cpu").numbers()
    assert sum(len(o["scores"]) for o in outs) > 0
    assert got["score_err"] < 1e-5 and got["miss_gap"] < 1e-5, got
    assert got["box_err"] < 1e-4 and got["lost_frames"] == 0 and got["overlap_excess"] < 1e-4, got
    # the same detections, one for one, where no near-tie reorders them
    for o, r in zip(outs, refs):
        assert len(o["scores"]) == r.det_scores.numel()
        np.testing.assert_allclose(np.sort(o["scores"]), np.sort(r.det_scores.numpy()), atol=1e-5)


def test_reference_plan_matches_published_letterbox():
    """720x1280 onto a 640 canvas: 360x640 resized, 384x640 canvas, 12 rows
    of fill above (the COCO 720p case); 375x500 onto the fixed 640x640."""
    p = pipeline.plan((720, 1280), (640, 640), 32)
    assert (p.resized, p.canvas, p.offset) == ((360, 640), (384, 640), (12, 0))
    p = pipeline.plan((375, 500), (640, 640), 32, (640, 640))
    assert (p.resized, p.canvas, p.offset) == ((480, 640), (640, 640), (80, 0))
    box = torch.tensor([[0.0, 12.0, 640.0, 372.0]])
    np.testing.assert_allclose(pipeline.rescale(box, (384, 640), (720, 1280)).numpy(),
                               [[0.0, 0.0, 1280.0, 720.0]], atol=1e-4)


def test_greedy_nms_plain_loop():
    """The batched greedy NMS against a loop over candidates."""
    g = torch.Generator().manual_seed(0)
    xy = torch.rand(2, 60, 2, generator=g) * 50
    boxes = torch.cat([xy, xy + 5 + torch.rand(2, 60, 2, generator=g) * 20], -1)
    labels = torch.randint(0, 3, (2, 60), generator=g)
    valid = torch.rand(2, 60, generator=g) > 0.1
    keep = pipeline.greedy_nms(boxes, labels, valid, 0.45, stop_after=60)
    for b in range(2):
        kept = []
        for i in range(60):
            if valid[b, i] and all(not (labels[b, j] == labels[b, i] and
                                        pipeline.box_iou(boxes[b, j:j + 1], boxes[b, i:i + 1])[0, 0] > 0.45)
                                   for j in kept):
                kept.append(i)
        assert torch.nonzero(keep[b]).flatten().tolist() == kept


def test_calibration_reaches_target():
    """Every frame has at least the target count of pairs above 0.25 once
    the shift is added (the copied bisection)."""
    from portbench.reference.arith import candidate_shift

    g = torch.Generator().manual_seed(1)
    logits = [torch.randn(2, 300, 11, generator=g) - 4.0]
    d = candidate_shift(logits, target=50, margin=0.0)
    s = torch.sigmoid(logits[0][..., 4:5] + d) * torch.sigmoid(logits[0][..., 5:] + d)
    assert int((s > 0.25).sum(dim=(1, 2)).min()) >= 50
    d_less = d - 0.01
    s = torch.sigmoid(logits[0][..., 4:5] + d_less) * torch.sigmoid(logits[0][..., 5:] + d_less)
    assert int((s > 0.25).sum(dim=(1, 2)).min()) < 50
