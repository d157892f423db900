"""The stage profiler and the regression harness of the port on the CPU,
against the JAX package where it computes the same thing.

- ``tools/profile_stages`` at ``--size 96 --batch 1 --topk 32`` prints
  every row of JAX's tool and of the cell-path prefixes, and its last
  prefix equals ``batched_postprocess_from_heads`` bit for bit.  On the
  same head logits the last prefix's detections equal JAX's cell path
  (``flatten_pad='cell', topk_impl='bisect'``): count, labels and validity
  exact, scores within 1e-6 relative, boxes within 1e-6 relative + 1e-5
  (tests/test_torch_postprocess.py's bounds: an ulp of the float32
  sigmoid).  Each prefix's output has its stage's shape.
- ``tools/regression``: ``--selftest`` end to end (bit parity ``exact``,
  floor ``pass``); ``check_bit_parity`` exact on a fabricated checkpoint;
  ``run_map_floor``'s metrics equal to JAX's ``COCOEvaluator`` on the same
  detections and targets, both rounded as the tools round (a random
  network's near-tied candidates reorder under 1e-5 logit differences, so
  the two networks' detections are not compared).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_fixture import make_checkpoint
from yolort_tpu.data.coco import COCODetection as JCOCODetection
from yolort_tpu.data.coco_eval import COCOEvaluator as JCOCOEvaluator
from yolort_tpu.ops import nms as JN
from yolort_tpu_torch.models.yolo import build_yolo
from yolort_tpu_torch.tools import profile_stages, regression

ROWS = ("backbone+pan+head", "+decode", "decode-out topk(k=32)", "postprocess",
        "cells concat + stage-1", "+ stage-1 select (bisect)", "+ segment gather",
        "+ seg extract + box decode", "+ stage-2 pair select", "+ box gather + NMS + compact",
        "full pipeline")
SMALL = ["--device", "cpu", "--size", "96", "--batch", "1", "--topk", "32"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_profile_stages_prints_every_row(capsys, dtype):
    rows = profile_stages.cli_main(SMALL + ["--dtype", dtype, "--calibrate"])
    out = capsys.readouterr().out
    assert [r["label"] for r in rows] == list(ROWS)
    for r in rows:
        assert r["label"] in out and r["ms"] > 0 and r["min_ms"] <= r["ms"]
        assert r["launches"] == {}  # the CPU runs the kernels' plain versions
    assert rows[-2]["bit_equal"] is True and "bit-equal" in out
    assert "imgs/sec" in out and rows[-1]["images_per_s"] > 0


def test_profile_stages_takes_a_subset_and_refuses_unknown_stages():
    rows = profile_stages.cli_main(SMALL + ["--stages", "cells", "--row_gather", "pallas_full",
                                            "--score", "0.25"])
    assert [r["label"] for r in rows] == list(ROWS[4:10])
    with pytest.raises(SystemExit):
        profile_stages.cli_main(SMALL + ["--stages", "nms_pallas"])


def shifted_model(seed, **kw):
    """yolov5s on the CPU, its head biases raised so that the 96x96 frame
    carries hundreds of candidates."""
    from yolort_tpu_torch.utils.profiling import shift_head_bias

    m = build_yolo("yolov5_darknet_pan_s_r60", device="cpu", seed=seed, **kw)
    shift_head_bias(m, 5.0)
    return m


@pytest.mark.parametrize("cfg", [dict(score_thresh=0.005, pre_nms_topk=32),
                                 dict(score_thresh=0.25, pre_nms_topk=512)])
def test_last_prefix_matches_the_jax_cell_path(cfg):
    model = shifted_model(0, **cfg)
    x = torch.from_numpy(np.random.default_rng(0).random((2, 96, 128, 3), dtype=np.float32))
    with torch.inference_mode():
        heads = model.head_outputs(x)
        prefixes = profile_stages.cell_prefixes(model, heads)
        outs = [fn() for _, fn in prefixes]
    bsz, na = 2, 3 * (12 * 16 + 6 * 8 + 3 * 4)
    k = min(cfg["pre_nms_topk"], na * 80)
    k1 = min(k + 8, na)
    cells, per_anchor = outs[0]
    assert cells.shape == (bsz, na // 3, 255) and per_anchor.shape == (bsz, na)
    assert outs[1][2].shape == (bsz, k1) and outs[2][0].shape == (bsz, k1, 85)
    assert outs[3][0].shape == (bsz, k1, 80) and outs[3][1].shape == (bsz, k1, 4)
    assert outs[4][0].shape == (bsz, k)
    got = outs[-1]
    assert all(torch.equal(a, b) for a, b in zip(got, model.postprocess(heads)))
    want = jax.jit(lambda hs: JN.batched_postprocess_from_heads(
        hs, model.strides, model.anchor_grids, num_classes=80, nms_thresh=0.45,
        detections_per_img=300, flatten_pad="cell", topk_impl="bisect",
        row_gather="pallas_bisect", nms_impl="xla", **cfg,
    ))([jnp.asarray(h.numpy()) for h in heads])
    assert (got.num.numpy() >= 10).all()
    np.testing.assert_array_equal(got.num.numpy(), np.asarray(want.num))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def selftest(tmp_path_factory):
    """The port's --selftest run once on the CPU: (report, its directory)."""
    root = tmp_path_factory.mktemp("selftest")
    report = regression.cli_main(["--selftest", "--selftest-dir", str(root), "--device", "cpu"])
    return report, root


def test_selftest_passes(selftest):
    report, root = selftest
    assert report["bit_parity"] == "exact" and report["map_floor"] == "pass"
    assert report["metrics"]["AP"] > 25.0 and report["metrics"]["AP50"] > 25.0
    assert (root / "annotations" / "instances_train2017.json").exists()


def test_map_floor_metrics_equal_jax_evaluator(selftest):
    """The port's run_map_floor and JAX's COCOEvaluator given the same
    detections (the port's, in the original frames) and JAX's dataset's
    targets of the same files."""
    _, root = selftest
    preds = []
    got = regression.run_map_floor(str(root / "fixture_s.pt"), str(root), 320, 4, 1e-6,
                                   collect_preds=preds, max_dets=300, device="cpu")
    img_dir, ann = regression.find_coco128_layout(root)
    ds = JCOCODetection(str(img_dir), str(ann))
    assert len(preds) == len(ds) == 8
    ev = JCOCOEvaluator(max_dets=300)
    for rec, image_id in zip(preds, ds.ids):
        assert int(rec["image"]) == image_id
        t = ds.get_target(image_id)
        ev.update([{k: rec[k] for k in ("boxes", "scores", "labels")}],
                  [{k: t[k] for k in ("boxes", "labels", "iscrowd", "area")}])
    want = {k: round(v * 100, 2) for k, v in ev.compute().items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k] or (math.isnan(got[k]) and math.isnan(want[k])), k
    assert got["AP"] > 25.0


def test_bit_parity_on_a_fabricated_checkpoint(tmp_path):
    path = tmp_path / "s.pt"
    make_checkpoint(str(path), nc=7, dm=0.33, wm=0.25, seed=1)
    report = regression.check_bit_parity(str(path), img_size=128, device="cpu")
    assert report == {"bit_parity": "exact", "max_delta": 0.0, "num_classes": 7, "size": "n"}


def test_regression_cli_needs_weights():
    with pytest.raises(SystemExit):
        regression.cli_main(["--device", "cpu"])
