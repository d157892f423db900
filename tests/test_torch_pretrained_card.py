"""``pretrained=True`` and the stage profiler on the card (``cuda`` marker;
skips without one), JAX-free:

    python -m pytest --noconftest tests/test_torch_pretrained_card.py -m cuda

- ``yolov5n(pretrained=True)`` from a weights directory holding a
  fabricated checkpoint (``.pt``, then the ``.npz`` of it) serves on the
  card with detections bit-equal to ``YOLOv5.load_from_yolov5`` of the
  same file, and the route's exact launches (with ``bias_act`` once a
  biased conv);
- ``tools/profile_stages`` on the card: each cell-path prefix launches
  exactly its stages' kernels (fused_cells_stage1 1; bisect_count 1; then
  bisect_count 2 and the route's fetch kernel 1; then nms_mask 1), the
  decoded postprocess bisect_count 2, fetch 2, nms_mask 1, the full
  pipeline the route's four kernels and ``bias_act`` once a biased conv
  of the network, and the last prefix's detections are
  bit-equal to ``batched_postprocess_from_heads``'.
"""

import numpy as np
import pytest
import torch

from torch_fixture import make_checkpoint
from yolort_tpu_torch import YOLOv5, yolov5n
from yolort_tpu_torch.models._checkpoint import convert_yolov5_checkpoint
from yolort_tpu_torch.ops import blocks
from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
from yolort_tpu_torch.tools import profile_stages

ARCH = "yolov5_darknet_pan_n_r60"
ROUTES = ("pallas_bisect", "pallas_lookup", "pallas_full")
FETCH = {"pallas_bisect": "row_fetch", "pallas_lookup": "lookup_fetch",
         "pallas_full": "select_extract"}
# the biased float convs of a fused r6.0 network (profile_stages' default
# arch), each one bias_act launch a forward on the card
R60_CONVS = 60


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def launches() -> dict:
    torch.cuda.synchronize()
    return {f.__name__: f.launches for f in KERNELS if f.launches}


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["pt", "npz"])
def test_pretrained_on_the_card_equals_load_from_yolov5(cuda_device, tmp_path, monkeypatch,
                                                        form):
    src = tmp_path / "src.pt"
    make_checkpoint(str(src), nc=80, dm=0.33, wm=0.25, seed=5)
    wd = tmp_path / "weights"
    wd.mkdir()
    if form == "pt":
        (wd / f"{ARCH}_coco.pt").write_bytes(src.read_bytes())
    else:
        convert_yolov5_checkpoint(str(src), str(wd), postfix="coco.npz")
    monkeypatch.setenv("YOLORT_TPU_WEIGHTS", str(wd))
    monkeypatch.delenv("YOLORT_HUB_BASE", raising=False)
    cfg = dict(score_thresh=0.005, nms_thresh=0.45)
    got_m = yolov5n(pretrained=True, **cfg)
    want_m = YOLOv5.load_from_yolov5(str(src), **cfg)
    assert got_m.device.type == "cuda"
    frames = list(np.random.default_rng(0).integers(0, 256, (4, 480, 640, 3), dtype=np.uint8))
    reset_launch_counts()
    got = got_m(frames)
    assert launches() == {"fused_cells_stage1": 1, "nms_mask": 1, "bisect_count": 2,
                          "row_fetch": 1, "bias_act": blocks.biased_float_convs(got_m.model)}
    want = want_m(frames)
    for g, w in zip(got, want):
        assert len(g["boxes"]) > 0
        for key in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(g[key], w[key])


@pytest.mark.cuda
@pytest.mark.parametrize("route", ROUTES)
def test_profile_stages_prefix_launches_on_the_card(cuda_device, route):
    fetch = FETCH[route]
    rows = profile_stages.cli_main([
        "--batch", "2", "--size", "320", "--topk", "512", "--score", "0.25", "--calibrate",
        "--dtype", "float32", "--stages", "postprocess,cells,full", "--row_gather", route])
    by_label = {r["label"]: r["launches"] for r in rows}
    s1 = {"fused_cells_stage1": 1}
    s1_select = {**s1, "bisect_count": 1}
    s2 = {**s1, "bisect_count": 2, fetch: 1}
    assert by_label == {
        "postprocess": {"bisect_count": 2, fetch: 2, "nms_mask": 1},
        "cells concat + stage-1": s1,
        "+ stage-1 select (bisect)": s1_select,
        "+ segment gather": s1_select,
        "+ seg extract + box decode": s1_select,
        "+ stage-2 pair select": s2,
        "+ box gather + NMS + compact": {**s2, "nms_mask": 1},
        "full pipeline": {**s2, "nms_mask": 1, "bias_act": R60_CONVS},
    }
    assert rows[-2]["bit_equal"] is True
    assert all(r["ms"] > 0 for r in rows)
