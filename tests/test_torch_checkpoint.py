"""Checkpoint ingestion of the port against the JAX package and the torch
oracle, on the CPU, for every family: ultralytics-layout checkpoints
fabricated by ``tests/torch_fixture.make_checkpoint`` (fp16, random
BatchNorm statistics, the stub-unpickling path).

- ``load_from_ultralytics``: the same metadata as JAX's, and every leaf
  bit-equal (both fold BatchNorm in the same float64 numpy arithmetic).
- The port's ``decode`` against the oracle's decoded predictions, within
  the tolerance of the JAX test of that family (tests/test_checkpoint*.py:
  the oracle holds the fp16 weights unfolded, the port folds them).
- ``YOLOv5.load_from_yolov5(path, device="cpu")`` against the JAX
  package's ``load_from_yolov5`` on the same frames, through the JAX cell
  path as tests/test_torch_slice.py composes it: matched by label with
  boxes within 1e-3 px.
- An ``.npz`` written by either package's ``save_params`` loads in the
  other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_fixture import make_checkpoint
from yolort_tpu.models import _checkpoint as JC
from yolort_tpu.models import transform as JT
from yolort_tpu.models.yolov5 import YOLOv5 as JaxYOLOv5
from yolort_tpu.ops import nms as JN
from yolort_tpu_torch.models import _checkpoint as TC
from yolort_tpu_torch.models import transform as TT
from yolort_tpu_torch.models._bridge import params_from_jax
from yolort_tpu_torch.models.yolo import YOLO
from yolort_tpu_torch.models.yolov5 import YOLOv5

# family: (make_checkpoint keywords, load version, YOLO keywords, nc, decode image (H, W),
# decode tolerance of the JAX test (rtol, atol)); nc and seeds as the JAX tests
FAMILIES = {
    "r6.0": (dict(seed=3), "r6.0", {}, 7, (64, 96), (2e-3, 2e-2)),
    "p6": (dict(seed=4, p6=True), "r6.0", {}, 5, (128, 128), (2e-3, 3e-2)),
    "r3.1": (dict(seed=12, version="r3.1"), "r3.1", {}, 4, (96, 128), (2e-3, 3e-2)),
    "r4.0": (dict(seed=8, version="r4.0"), "r4.0", {}, 6, (96, 128), (2e-3, 3e-2)),
    "tan": (dict(seed=2, version="tan"), "r4.0", dict(use_tan=True), 6, (96, 128), (2e-3, 3e-2)),
}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def ckpt(request, tmp_path_factory):
    make_kw, version, yolo_kw, nc, hw, tol = FAMILIES[request.param]
    path = str(tmp_path_factory.mktemp("ckpt") / f"{request.param}.pt")
    oracle = make_checkpoint(path, nc=nc, dm=0.33, wm=0.25, **make_kw)
    return request.param, path, oracle, version, yolo_kw, hw, tol


def test_load_from_ultralytics_matches_jax_bit_for_bit(ckpt):
    name, path, _, version, _, _, _ = ckpt
    want = JC.load_from_ultralytics(path, version=version)
    got = TC.load_from_ultralytics(path, version=version)
    for key in ("num_classes", "depth_multiple", "width_multiple", "strides", "anchor_grids",
                "use_p6", "size"):
        assert got[key] == want[key], key
    assert got["use_p6"] == (name == "p6") and got["size"] == "n"
    jl, tl = TC._flatten(want["params"]), TC._flatten(got["params"])
    assert sorted(jl) == sorted(tl) and len(tl) > 100
    for key, w in jl.items():
        assert tl[key].dtype == w.dtype == np.float32, key
        np.testing.assert_array_equal(tl[key], w, err_msg=key)
    if name == "r3.1":  # the CSP gate's BatchNorm stays unfused
        assert "pan/inner/0/bn/gamma" in tl
    if name == "tan":  # the attention flattened into its TransformerLayer
        assert "pan/inner/0/m/tr/0/in_proj_w" in tl


def test_decode_matches_the_torch_oracle(ckpt):
    name, path, oracle, version, yolo_kw, (h, w), (rtol, atol) = ckpt
    info = TC.load_from_ultralytics(path, version=version)
    model = YOLO(info["depth_multiple"], info["width_multiple"], device="cpu", version=version,
                 num_classes=info["num_classes"], use_p6=info["use_p6"], strides=info["strides"],
                 anchor_grids=info["anchor_grids"], **yolo_kw)
    params_from_jax(info["params"], model)
    x = np.random.default_rng(0).uniform(0, 1, (1, 3, h, w)).astype(np.float32)
    with torch.no_grad():
        ref = oracle(torch.from_numpy(x)).numpy()  # (1, total, no), anchor-major a level
        outs = model.head_outputs(torch.from_numpy(x.transpose(0, 2, 3, 1)))
        pred = model.decode(torch.from_numpy(x.transpose(0, 2, 3, 1))).numpy()
    na, no = 3, info["num_classes"] + 5
    ref_hwa, off = [], 0
    for o in outs:  # the oracle's (a, h, w) order per level -> the port's (h, w, a)
        lh, lw = o.shape[1:3]
        ref_hwa.append(ref[:, off:off + na * lh * lw].reshape(1, na, lh, lw, no)
                       .transpose(0, 2, 3, 1, 4).reshape(1, -1, no))
        off += na * lh * lw
    ref_hwa = np.concatenate(ref_hwa, axis=1)
    assert pred.shape == ref_hwa.shape and len(outs) == len(info["strides"])
    np.testing.assert_allclose(pred, ref_hwa, rtol=rtol, atol=atol)
    np.testing.assert_allclose(pred[..., 4:], ref_hwa[..., 4:], atol=2e-3)


SERVE = dict(score_thresh=0.05, pre_nms_topk=512)


def test_load_from_yolov5_matches_jax(ckpt):
    """The models both packages' ``load_from_yolov5`` build from one
    checkpoint: head outputs within atol 1e-4 on the same frames (each
    package letterboxes them), and the JAX package's head outputs give the
    JAX cell path's detections through the port's postprocess (count,
    labels and order exactly; scores and boxes within rtol 1e-6, the
    tolerance of tests/test_torch_stage1.py: torch's and XLA's sigmoids
    differ by up to 2 ulp, and one r4.0 score does by 1).  Detections are compared on one set of
    logits because a fabricated network scores nearly every pair alike:
    the top scores lie within 1e-6 of each other, under the 1e-5 by which
    the two frameworks' float networks differ, so near-ties would decide
    which boxes an end-to-end run keeps."""
    name, path, _, version, yolo_kw, _, _ = ckpt
    size, div = (128, 64) if name == "p6" else (96, 32)
    kw = dict(version=version, size=(size, size), size_divisible=div, **SERVE, **yolo_kw)
    port = YOLOv5.load_from_yolov5(path, device="cpu", **kw)
    jax_model = JaxYOLOv5.load_from_yolov5(path, **kw)
    jm, params = jax_model.model, jax_model.params
    assert port.model.strides == jm.strides and port.model.anchor_grids == jm.anchor_grids
    raw = np.random.default_rng(5).random((2, 80, 110, 3)).astype(np.float32)
    jplan = JT.make_plan([raw.shape[1:3]], size, size, div)[0]
    jcanvas = JT.letterbox_batch(jnp.asarray(raw), jplan, 114 / 255.0)
    want_heads = [np.asarray(h) for h in jax.jit(jm.head_outputs)(params, jcanvas)]
    plan = TT.make_plan([raw.shape[1:3]], size, size, div)[0]
    canvas = TT.letterbox_batch(torch.from_numpy(raw), plan)
    np.testing.assert_allclose(canvas.numpy(), np.asarray(jcanvas), atol=1e-6, rtol=0)
    with torch.no_grad():
        heads = port.model.head_outputs(canvas)
    for g, w in zip(heads, want_heads):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0)

    want = jax.jit(lambda hs: JN.batched_postprocess_from_heads(
        hs, jm.strides, jm.anchor_grids, num_classes=jm.num_classes,
        score_thresh=jm.score_thresh, nms_thresh=jm.nms_thresh,
        detections_per_img=jm.detections_per_img, pre_nms_topk=jm.pre_nms_topk,
        flatten_pad="cell", topk_impl="bisect", row_gather="pallas_bisect", nms_impl="xla",
    ))([jnp.asarray(h) for h in want_heads])
    with torch.no_grad():
        got = port.model.postprocess([torch.from_numpy(h) for h in want_heads])
    assert (got.num.numpy() > 0).all()
    np.testing.assert_array_equal(got.num.numpy(), np.asarray(want.num))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-6, atol=1e-5)
    # and the port serves the frames end to end
    for d in port(list(raw)):
        assert len(d["boxes"]) > 0 and (d["labels"] < port.num_classes).all()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_npz_written_by_either_package_loads_in_the_other(tmp_path, writer):
    path = str(tmp_path / "fixture.pt")
    make_checkpoint(path, nc=3, seed=6, p6=True)
    info = TC.load_from_ultralytics(path)
    meta = {"num_classes": info["num_classes"], "strides": info["strides"], "use_p6": True}
    out = str(tmp_path / "params.npz")
    save, load = (TC.save_params, JC.load_params) if writer == "port" else (JC.save_params,
                                                                           TC.load_params)
    save(out, info["params"], meta)
    params, got_meta = load(out)
    assert got_meta == meta
    want, got = TC._flatten(info["params"]), TC._flatten(params)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)
