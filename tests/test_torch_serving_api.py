"""The serving surface beside ``YOLOv5.__call__``: ``fixed_shape`` canvases
and mixed-size batches, ``letterbox_numpy``, ``predict_rich`` and
``DetectionResults``, ``YOLO(classes_per_anchor=...)`` and
``with_thresholds``, and the port's torch.hub file, against the JAX
package on the CPU.

- ``letterbox_numpy`` (numpy, no OpenCV) against JAX's (OpenCV) and JAX's
  in-graph ``letterbox_image`` within atol 2e-3, the bound of JAX's own
  tests/test_transform.py; ``letterbox_images`` slices equal to
  ``letterbox_batch`` of each image alone, bit for bit.
- ``_infer_fixed`` and a mixed-size ``__call__`` against the JAX pipeline
  composed as ``YOLOv5._infer_fixed`` composes it (cell path, bisect
  select) on the same canvases: detections matched by label with boxes
  within 1e-3 px (tests/test_torch_slice.py's tolerance).
- ``predict_rich``'s summary, records and render against JAX's
  ``DetectionResults`` on the same images and predictions: equal.
- The hub file has the root ``hubconf.py``'s 11 factories as its entry
  points and builds through ``torch.hub.load(..., source="local")``.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolort_tpu_torch
from torch_parity import tiny_pair
from yolort_tpu.models import transform as JT
from yolort_tpu.ops import nms as JN
from yolort_tpu.utils.results import DetectionResults as JaxResults
from yolort_tpu_torch.models import transform as TT
from yolort_tpu_torch.models.yolov5 import YOLOv5
from yolort_tpu_torch.utils.results import DetectionResults

ROOT = Path(__file__).resolve().parents[1]
FIXED = (128, 160)
SIZE = 128
SHAPES = [(100, 130), (90, 60), (128, 128), (37, 201)]


@pytest.mark.parametrize("hw,canvas,size", [
    ((77, 133), (64, 128), 64), ((480, 640), (640, 640), 640), ((30, 20), (96, 64), 96),
    ((721, 1281), (384, 640), 640), ((90, 60), FIXED, SIZE),
])
def test_letterbox_numpy_matches_jax(hw, canvas, size):
    img = np.random.default_rng(hw[0]).uniform(0, 1, (*hw, 3)).astype(np.float32)
    got = TT.letterbox_numpy(img, canvas, size, size)
    want = JT.letterbox_numpy(img, canvas, size, size)
    plan = JT.make_plan([hw], size, size, fixed_shape=canvas)[0]
    graph = np.asarray(JT.letterbox_image(jnp.asarray(img), plan))
    assert got.shape == want.shape == (*canvas, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=2e-3)
    np.testing.assert_allclose(got, graph, atol=2e-3)
    u8 = (img * 255).astype(np.uint8)
    assert TT.letterbox_numpy(u8, canvas, size, size).dtype == np.uint8


def test_letterbox_images_slices_equal_each_image_alone():
    rng = np.random.default_rng(2)
    images = [torch.from_numpy(rng.random((*s, 3)).astype(np.float32)) for s in SHAPES]
    plans = TT.make_plan(SHAPES, SIZE, SIZE, fixed_shape=FIXED)
    canvas = TT.letterbox_images(images, plans)
    assert canvas.shape == (len(SHAPES), *FIXED, 3)
    assert canvas.permute(0, 3, 1, 2).is_contiguous(memory_format=torch.channels_last)
    for i, (im, plan) in enumerate(zip(images, plans)):
        assert torch.equal(canvas[i], TT.letterbox_batch(im[None], plan)[0])
    with pytest.raises(ValueError, match="canvases"):
        TT.letterbox_images([images[0], images[3]], TT.make_plan([SHAPES[0]], SIZE, SIZE)
                            + TT.make_plan([SHAPES[3]], SIZE, SIZE))


def _jax_infer_fixed(jm, params, canvases, orig):
    """JAX ``YOLOv5._infer_fixed``, its postprocess on the cell path with
    bisect selection (the program an accelerator runs)."""

    @jax.jit
    def infer(params, canvases, orig):
        outs = jm.head_outputs(params, canvases)
        det = JN.batched_postprocess_from_heads(
            outs, jm.strides, jm.anchor_grids, num_classes=jm.num_classes,
            score_thresh=jm.score_thresh, nms_thresh=jm.nms_thresh,
            detections_per_img=jm.detections_per_img, pre_nms_topk=jm.pre_nms_topk,
            flatten_pad="cell", topk_impl="bisect", row_gather="pallas_bisect", nms_impl="xla",
        )
        return det, JT.scale_coords_back(det.boxes, FIXED, orig[:, None, :])

    det, boxes = infer(params, jnp.asarray(canvases), jnp.asarray(orig))
    return [{"boxes": np.asarray(boxes[i][:n]), "labels": np.asarray(det.labels[i][:n])}
            for i, n in enumerate(np.asarray(det.num))]


def _match(got, want):
    for g, w in zip(got, want):
        assert len(w["boxes"]) > 0 and len(g["boxes"]) == len(w["boxes"])
        for box, label in zip(w["boxes"], w["labels"]):
            close = (g["labels"] == label) & (np.abs(g["boxes"] - box).max(-1) <= 1e-3)
            assert close.any(), (box, label)


@pytest.fixture(scope="module")
def fixed_pair():
    jm, params, tm = tiny_pair(seed=5, head_shift=7.0, score_thresh=0.25, pre_nms_topk=512)
    model = YOLOv5(model=tm, device="cpu", size=(SIZE, SIZE), fixed_shape=FIXED)
    rng = np.random.default_rng(3)
    images = [rng.integers(0, 256, (*s, 3), dtype=np.uint8) for s in SHAPES]
    return jm, params, model, images


def test_infer_fixed_and_mixed_call_match_jax(fixed_pair):
    jm, params, model, images = fixed_pair
    canvases = model.canvas_mixed([torch.from_numpy(im) for im in images])
    assert canvases.shape == (len(images), *FIXED, 3)
    # the device letterbox against JAX's host one
    for im, c in zip(images, canvases):
        want = JT.letterbox_numpy(im.astype(np.float32) / 255.0, FIXED, SIZE, SIZE)
        np.testing.assert_allclose(c.numpy(), want, atol=2e-3)
    orig = np.asarray([im.shape[:2] for im in images], np.float32)
    want = _jax_infer_fixed(jm, params, canvases.numpy(), orig)
    det = model._infer_fixed(canvases, torch.from_numpy(orig))
    got = [{"boxes": det.boxes[i, :n].numpy(), "labels": det.labels[i, :n].numpy()}
           for i, n in enumerate(det.num.tolist())]
    _match(got, want)
    served = model(images)  # one batch on the fixed canvas
    _match(served, want)
    for d in served:
        assert d["labels"].dtype == np.int64 and d["boxes"].dtype == np.float32


def test_mixed_batch_equals_each_image_served_alone(fixed_pair):
    """Each image's detections in the mixed batch against the image served
    alone (a same-size batch, letterboxed in-graph onto ``fixed_shape``):
    equal counts, labels, boxes within 1e-4 px; the canvases are equal."""
    _, _, model, images = fixed_pair
    mixed = model(images)
    for im, d in zip(images, mixed):
        alone = model([im])[0]
        assert len(d["boxes"]) == len(alone["boxes"]) > 0
        np.testing.assert_array_equal(d["labels"], alone["labels"])
        np.testing.assert_allclose(d["boxes"], alone["boxes"], atol=1e-4)
        assert model.canvas(torch.from_numpy(im)[None])[0].shape[1:3] == FIXED
    # float and uint8 images of one size are one batch on the fixed canvas too
    both = model([images[0], images[0].astype(np.float32) / 255.0])
    np.testing.assert_allclose(both[0]["boxes"], both[1]["boxes"], atol=1e-3)
    free = YOLOv5(model=model.model, size=(SIZE, SIZE))
    with pytest.raises(ValueError, match="fixed_shape"):
        free.canvas_mixed([torch.from_numpy(im) for im in images])


def test_predict_rich_matches_jax_results(fixed_pair, tmp_path):
    _, _, model, images = fixed_pair
    rich = model.predict_rich(images)
    preds = model(images)
    jres = JaxResults(images, preds)
    assert len(rich) == len(images) and rich.summary() == jres.summary()
    assert "no detections" not in rich.summary()
    assert rich.records() == jres.records()
    assert [r.columns.tolist() for r in rich.pandas()] == [r.columns.tolist() for r in jres.pandas()]
    for a, b in zip(rich.render(), jres.render()):
        assert a.dtype == np.uint8 and np.array_equal(a, b)
    assert len(rich.crop()) == len(jres.crop())
    saved = rich.save(str(tmp_path / "out"))
    assert len(saved) == len(images) and all(Path(p).exists() for p in saved)
    # uint8 frames stay uint8 for the device; float ones become float32
    one = model.collate_images(images[0], None)
    assert len(one) == 1 and one[0].dtype == np.uint8
    assert model.collate_images([images[0].astype(np.float64)], None)[0].dtype == np.float32
    with pytest.raises(ValueError, match="HWC"):
        model.collate_images([np.zeros((4, 4))], None)
    path = tmp_path / "frame.png"
    import cv2

    cv2.imwrite(str(path), cv2.cvtColor(images[1], cv2.COLOR_RGB2BGR))
    by_path = model.predict_rich(str(path))
    assert by_path.files == [str(path)] and len(by_path[0]["boxes"]) > 0


def test_classes_per_anchor_and_with_thresholds_reach_the_postprocess(fixed_pair):
    jm, params, model, images = fixed_pair
    yolo = model.model
    canvas = model.canvas(torch.from_numpy(images[0])[None])[0]
    with torch.no_grad():
        heads = yolo.head_outputs(canvas)
    base = yolo.postprocess(heads)
    strict = yolo.with_thresholds(score_thresh=0.6, pre_nms_topk=64)
    assert strict.head is yolo.head and (yolo.score_thresh, yolo.pre_nms_topk) == (0.25, 512)
    assert 0 < int(strict.postprocess(heads).num[0]) < int(base.num[0])
    yolo.classes_per_anchor = 2
    try:
        cut = yolo.postprocess(heads)
        want = jax.jit(lambda hs: JN.batched_postprocess_from_heads(
            hs, jm.strides, jm.anchor_grids, num_classes=80, score_thresh=0.25,
            pre_nms_topk=512, topk_impl="bisect", anchor_arith=True, nms_impl="xla",
            classes_per_anchor=2))([jnp.asarray(h.numpy()) for h in heads])
    finally:
        yolo.classes_per_anchor = None
    np.testing.assert_array_equal(cut.num.numpy(), np.asarray(want.num))
    np.testing.assert_array_equal(cut.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(cut.boxes.numpy(), np.asarray(want.boxes), rtol=1e-6, atol=1e-5)
    m = yolort_tpu_torch.yolov5n(device="cpu", classes_per_anchor=3, fixed_shape=(96, 96))
    assert m.model.classes_per_anchor == 3 and m.fixed_shape == (96, 96)
    with pytest.raises(ValueError, match="does not fit"):
        m([np.zeros((40, 50, 3), np.uint8)])  # letterboxed to 512x640


def test_load_from_yolov5_takes_fixed_shape(tmp_path):
    from tests.torch_fixture import make_checkpoint

    path = str(tmp_path / "n.pt")
    make_checkpoint(path, nc=80, dm=0.33, wm=0.25)
    m = YOLOv5.load_from_yolov5(path, device="cpu", size=(SIZE, SIZE), fixed_shape=FIXED)
    assert m.fixed_shape == FIXED
    out = m([np.zeros((50, 70, 3), np.uint8), np.zeros((60, 40, 3), np.uint8)])
    assert len(out) == 2


def _hub_names(module) -> list:
    return sorted(n for n in dir(module) if callable(getattr(module, n)) and not n.startswith("_"))


def test_hub_file_lists_the_root_factories_and_builds(monkeypatch, tmp_path):
    spec = importlib.util.spec_from_file_location("root_hubconf", ROOT / "hubconf.py")
    root = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root)
    hub_dir = str(ROOT / "yolort_tpu_torch")
    # torch.hub.list reads GitHub repositories only: list the local file's
    # entry points as it lists a repository's (public callables)
    hub = torch.hub._import_module("hubconf", str(ROOT / "yolort_tpu_torch" / "hubconf.py"))
    names = _hub_names(hub)
    assert hub.dependencies == ["torch", "numpy"]
    assert sorted(names) == _hub_names(root) and len(names) == 11
    m = torch.hub.load(hub_dir, "yolov5n", source="local", device="cpu", score_thresh=0.3,
                       size=(96, 96), fixed_shape=(96, 96))
    assert isinstance(m, YOLOv5) and m.device == torch.device("cpu")
    assert m.model.score_thresh == 0.3 and m.fixed_shape == (96, 96)
    assert len(m([np.zeros((40, 50, 3), np.uint8), np.zeros((30, 20, 3), np.uint8)])) == 2
    # pretrained=True reaches the factory: with an empty weights directory
    # and no hub it finds no weights
    monkeypatch.setenv("YOLORT_TPU_WEIGHTS", str(tmp_path))
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("YOLORT_HUB_BASE", raising=False)
    with pytest.raises(FileNotFoundError, match="No pretrained weights"):
        torch.hub.load(hub_dir, "yolov5s", source="local", pretrained=True, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            torch.hub.load(hub_dir, "yolov5n", source="local")
