"""The port's utilities and command-line tools against the JAX package's, on
the CPU (mirrors tests/test_utils.py:15-64, :86 and tests/test_results.py:44):

- ``data.datasets.LoadImages`` reads what the JAX package's reads, bit for
  bit, EXIF orientation included;
- ``utils.boxes`` on numpy arrays and on tensors, and ``utils.metrics``,
  equal to JAX's numpy results (float64 inputs; tensors within 1e-12);
- ``utils.annotations_converter`` and ``tools/convert_txt_to_json`` write
  JAX's json;
- ``tools/convert_yolov5_to_yolort`` writes the file JAX's converter writes
  (same name, same leaves, same ``__meta__``), and both packages'
  ``load_params`` read it;
- ``tools/eval_metric`` on a seeded synthetic COCO set and a ``.npz`` gives
  the metrics of JAX's ``tools/eval_metric.py`` on the same files, at the
  tolerance stated at the test; ``tools/detect`` gives ``YOLOv5``'s
  detections and saves one rendered image a frame.
Nothing of the JAX package is imported by the port's tools (checked in a
fresh process).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tests.torch_fixture import make_checkpoint
from torch_parity import randomize_convs, shift_head_bias
from yolort_tpu.models import _checkpoint as JC
from yolort_tpu.models.yolo import build_yolo as jax_build_yolo
from yolort_tpu.utils import boxes as JB
from yolort_tpu.utils import metrics as JM
from yolort_tpu_torch.models import _checkpoint as TC
from yolort_tpu_torch.utils import boxes as TB
from yolort_tpu_torch.utils import metrics as TM

REPO = Path(__file__).resolve().parent.parent


# --- LoadImages --------------------------------------------------------------

def test_load_images_reads_what_jax_reads(tmp_path):
    import cv2
    from PIL import Image

    from yolort_tpu.data.datasets import LoadImages as JaxLoadImages
    from yolort_tpu_torch.data.datasets import LoadImages

    rng = np.random.default_rng(0)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f"im{i}.png"), rng.integers(0, 256, (20, 30, 3), np.uint8))
    exif = Image.Exif()
    exif[0x0112] = 6  # rotated: read back transposed to 30x20
    Image.fromarray(rng.integers(0, 256, (20, 30, 3), np.uint8)).save(tmp_path / "rot.jpg",
                                                                     exif=exif)
    (tmp_path / "notes.txt").write_text("skip me")
    got, want = list(LoadImages(str(tmp_path))), list(JaxLoadImages(str(tmp_path)))
    assert len(got) == len(want) == 4
    for (gf, gi), (wf, wi) in zip(got, want):
        assert gf == wf and gi.dtype == np.float32
        np.testing.assert_array_equal(gi, wi)
    assert got[0][1].shape == (20, 30, 3) and got[-1][1].shape == (30, 20, 3)
    assert len(LoadImages(str(tmp_path / "*.png"))) == 3
    with pytest.raises(FileNotFoundError):
        LoadImages(str(tmp_path / "missing"))


# --- boxes and metrics -----------------------------------------------------

BOX_FNS = [
    ("xyxy2xywh", {}), ("xywh2xyxy", {}), ("xywhn2xyxy", dict(w=100, h=200, padw=10, padh=20)),
    ("xyxy2xywhn", dict(w=100, h=200)), ("xyxy2xywhn", dict(w=100, h=200, clip=True, eps=1e-3)),
    ("clip_boxes", dict(shape=(100, 60))), ("box_area", {}),
]


def _boxes(seed, n):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-10, 120, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(0, 80, (n, 2))], 1)


@pytest.mark.parametrize("name,kw", BOX_FNS)
def test_box_utilities_match_jax(name, kw):
    x = _boxes(1, 7)
    want = getattr(JB, name)(x, **kw)
    got = getattr(TB, name)(x, **kw)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(got, want)
    got_t = getattr(TB, name)(torch.from_numpy(x), **kw)
    assert isinstance(got_t, torch.Tensor)
    np.testing.assert_allclose(got_t.numpy(), want, rtol=0, atol=1e-12)


def test_pairwise_box_utilities_match_jax():
    a, b = _boxes(2, 5), _boxes(3, 6)
    pts = np.random.default_rng(4).uniform(0, 1, (4, 2))
    wh1, wh2 = np.abs(a[:, 2:] - a[:, :2]) + 1, np.abs(b[:, 2:] - b[:, :2]) + 1
    cases = [("box_iou", (a, b)), ("wh_iou", (wh1, wh2)), ("bbox_ioa", (a[0], b)),
             ("xyn2xy", (pts,))]
    for name, args in cases:
        want = getattr(JB, name)(*args)
        np.testing.assert_array_equal(getattr(TB, name)(*args), want, err_msg=name)
        got_t = getattr(TB, name)(*(torch.from_numpy(v) for v in args))
        np.testing.assert_allclose(got_t.numpy(), want, rtol=0, atol=1e-12, err_msg=name)


def _eq(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _eq(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, tuple):
        assert len(a) == len(b), what
        for i, (x, y) in enumerate(zip(a, b)):
            _eq(x, y, f"{what}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def test_metrics_match_jax():
    rng = np.random.default_rng(5)
    m = rng.random((6, 4))
    _eq(TM.fitness(m), JM.fitness(m), "fitness")
    rec, prec = np.sort(rng.random(9)), rng.random(9)
    _eq(TM.compute_ap(rec, prec), JM.compute_ap(rec, prec), "compute_ap")
    tp = rng.random((40, 10)) > 0.4
    conf, pred_cls, tgt_cls = rng.random(40), rng.integers(0, 4, 40), rng.integers(0, 5, 25)
    _eq(TM.ap_per_class(tp, conf, pred_cls, tgt_cls), JM.ap_per_class(tp, conf, pred_cls, tgt_cls),
        "ap_per_class")
    got, want = TM.ConfusionMatrix(nc=3), JM.ConfusionMatrix(nc=3)
    for seed in range(3):
        r = np.random.default_rng(10 + seed)
        dets = np.concatenate([_boxes(seed, 8), r.random((8, 1)), r.integers(0, 3, (8, 1))], 1)
        labels = np.concatenate([r.integers(0, 3, (5, 1)), dets[:5, :4] + r.normal(0, 4, (5, 4))],
                                1)
        got.process_batch(dets, labels)
        want.process_batch(dets, labels)
    _eq(got.matrix, want.matrix, "confusion")
    _eq(got.tp_fp(), want.tp_fp(), "tp_fp")
    assert got.matrix.sum() > 0


# --- annotations -------------------------------------------------------------

def _yolo_txt_set(root):
    import cv2

    imgd, lbld = root / "img", root / "lbl"
    imgd.mkdir(), lbld.mkdir()
    cv2.imwrite(str(imgd / "a.jpg"), np.zeros((100, 200, 3), np.uint8))
    cv2.imwrite(str(imgd / "b.png"), np.zeros((64, 48, 3), np.uint8))
    cv2.imwrite(str(imgd / "c.jpg"), np.zeros((30, 40, 3), np.uint8))  # no label file
    (lbld / "a.txt").write_text("1 0.5 0.5 0.2 0.4\n0 0.25 0.3 0.1 0.1\n")
    (lbld / "b.txt").write_text("1 0.4 0.6 0.3 0.2\nbad row\n")
    return imgd, lbld


def test_annotations_converter_and_its_cli_write_jax_json(tmp_path):
    from yolort_tpu.utils.annotations_converter import AnnotationsConverter as JaxConverter
    from yolort_tpu_torch.tools.convert_txt_to_json import cli_main
    from yolort_tpu_torch.utils.annotations_converter import AnnotationsConverter

    imgd, lbld = _yolo_txt_set(tmp_path)
    want = JaxConverter(str(imgd), str(lbld), ["cat", "dog"], year=2024).generate(
        str(tmp_path / "jax.json"))
    got = AnnotationsConverter(str(imgd), str(lbld), ["cat", "dog"], year=2024).generate()
    assert got == want and len(got["annotations"]) == 3
    names = tmp_path / "names.txt"
    names.write_text("cat\ndog\n")
    out = tmp_path / "cli.json"
    cli_main(["--image_root", str(imgd), "--label_root", str(lbld), "--class_names", str(names),
              "--output_path", str(out)])
    want = JaxConverter(str(imgd), str(lbld), ["cat", "dog"]).generate()
    assert json.loads(out.read_text()) == want


# --- checkpoint conversion ---------------------------------------------------

def test_converted_npz_reads_in_both_packages(tmp_path):
    from yolort_tpu_torch.tools.convert_yolov5_to_yolort import cli_main

    pt = str(tmp_path / "r60.pt")
    make_checkpoint(pt, nc=7, dm=0.33, wm=0.25, seed=3)
    (tmp_path / "port").mkdir(), (tmp_path / "jax").mkdir()
    got = cli_main(["--checkpoint_path", pt, "--output_path", str(tmp_path / "port")])
    want = JC.convert_yolov5_checkpoint(pt, str(tmp_path / "jax"))
    assert Path(got).name == Path(want).name == "yolov5_darknet_pan_n_r60_custom.npz"
    with np.load(got) as g, np.load(want) as w:
        assert sorted(g.files) == sorted(w.files)
        for key in w.files:
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    tparams, tmeta = TC.load_params(got)
    jparams, jmeta = JC.load_params(got)
    assert tmeta == jmeta and tmeta["num_classes"] == 7 and tmeta["size"] == "n"
    flat_j = TC._flatten(jax.tree_util.tree_map(np.asarray, jparams))
    flat_t = TC._flatten(tparams)
    assert sorted(flat_t) == sorted(flat_j)
    for key, w in flat_j.items():
        np.testing.assert_array_equal(flat_t[key], w, err_msg=key)


# --- eval_metric and detect ----------------------------------------------------

NC = 3
ARCH = "yolov5_darknet_pan_n_r60"


@pytest.fixture(scope="module")
def coco_set(tmp_path_factory):
    """A seeded synthetic COCO set of 6 images (a final partial batch at
    batch 4) and a yolov5n ``.npz`` with random BatchNorm statistics and its
    obj / class biases raised by 4 (candidates above the eval threshold)."""
    from yolort_tpu_torch.data._helper import create_synthetic_coco
    from yolort_tpu_torch.models._checkpoint import save_params

    root = tmp_path_factory.mktemp("coco")
    img_dir, ann = create_synthetic_coco(root / "set", num_images=6, num_classes=NC, seed=3,
                                         image_hw=(96, 128))
    jm = jax_build_yolo(ARCH, num_classes=NC)
    params = shift_head_bias(randomize_convs(jm.init(jax.random.PRNGKey(4)), 4), 4.0)
    npz = str(root / "yolov5n.npz")
    save_params(npz, params, {"num_classes": NC})
    return dict(img=str(img_dir), ann=str(ann), npz=npz, root=root)


def _eval_argv(s):
    return ["--checkpoint_path", s["npz"], "--arch", ARCH, "--image_path", s["img"],
            "--annotation_path", s["ann"], "--batch_size", "4", "--image_size", "128",
            "--num_chips", "1"]


def test_eval_metric_matches_the_jax_tool(coco_set, monkeypatch):
    """Both tools on the same files give the same metrics.  Both run the
    same postprocess on the same logits: JAX's tool its cell path
    (``flatten_pad='cell'``, ``topk_impl='bisect'``: the program the port
    ports; on the CPU its default is the ``lax.top_k`` flatten path), and
    the port's network hands on the JAX network's head outputs of the same
    canvases.  The two networks' float32 logits differ by ~1e-5 (held in
    tests/test_torch_model.py), and this random network's ~3000 candidates
    a frame, many of them near-tied, then leave NMS in another order, which
    moves AP by a third at this AP of ~0.002; the data module, the
    postprocess, the rescale and the evaluator are what is held here.
    JAX's tool pads the final partial batch to ``--batch_size`` (one jitted
    shape); the port's serves it as it is, so its stand-in network pads it
    the same way before calling the JAX network: XLA's logits of an image
    move by ~1e-7 with the batch's size, enough to reorder those ties."""
    import functools

    import jax.numpy as jnp

    from yolort_tpu.models._checkpoint import load_params as jax_load_params
    from yolort_tpu.ops import nms as jax_nms
    from yolort_tpu_torch.models.yolo import Detector
    from yolort_tpu_torch.tools.eval_metric import cli_main

    jparams, _ = jax_load_params(coco_set["npz"])
    jm = jax_build_yolo(ARCH, num_classes=NC)
    jax_heads = jax.jit(jm.head_outputs)

    def head_outputs(self, images):
        x, n = images.numpy(), images.shape[0]
        x = np.concatenate([x, np.repeat(x[-1:], 4 - n, 0)]) if n < 4 else x
        outs = jax_heads(jparams, jnp.asarray(x))
        return [torch.from_numpy(np.asarray(o)[:n]) for o in outs]

    monkeypatch.setattr(Detector, "head_outputs", head_outputs)
    monkeypatch.setattr(jax_nms, "batched_postprocess_from_heads", functools.partial(
        jax_nms.batched_postprocess_from_heads, flatten_pad="cell", topk_impl="bisect",
        row_gather="pallas_bisect"))
    got = cli_main(_eval_argv(coco_set) + ["--device", "cpu"])
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import eval_metric as jax_eval_metric
    finally:
        sys.path.remove(str(REPO / "tools"))
    want = {}
    from yolort_tpu.data import coco_eval as jce

    orig = jce.COCOEvaluator.compute

    def compute(self):
        out = orig(self)
        want.update(out)
        return out

    monkeypatch.setattr(jce.COCOEvaluator, "compute", compute)
    monkeypatch.setattr(sys, "argv", ["eval_metric.py"] + _eval_argv(coco_set))
    jax_eval_metric.cli_main()
    assert set(got) == set(want) and want["AP50"] > 0
    for key, w in want.items():
        np.testing.assert_equal(got[key], w, err_msg=key)  # NaN where a size has no box


def test_detect_serves_yolov5_and_saves_each_frame(tmp_path):
    import cv2

    from yolort_tpu_torch.data.datasets import LoadImages
    from yolort_tpu_torch.models.yolov5 import YOLOv5
    from yolort_tpu_torch.tools.detect import cli_main

    pt = str(tmp_path / "n.pt")
    make_checkpoint(pt, nc=80, dm=0.33, wm=0.25, seed=6)
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(8)
    for i, hw in enumerate([(60, 80), (90, 70)]):
        cv2.imwrite(str(src / f"f{i}.jpg"), rng.integers(0, 256, (*hw, 3), np.uint8))
    out = tmp_path / "out"
    results = cli_main(["--source", str(src), "--checkpoint_path", pt, "--score_thresh", "0.01",
                        "--save_dir", str(out), "--device", "cpu"])
    model = YOLOv5.load_from_yolov5(pt, score_thresh=0.01, device="cpu")
    want = model([img for _, img in LoadImages(str(src))])
    assert len(results) == 2 and len(list(out.iterdir())) == 2
    for g, w in zip(results.predictions, want):
        assert len(w["scores"]) > 0
        for key in ("boxes", "scores", "labels"):
            np.testing.assert_array_equal(g[key], w[key])


def test_the_tools_import_nothing_of_jax():
    code = ("import sys\n"
            "import yolort_tpu_torch.tools.detect, yolort_tpu_torch.tools.eval_metric\n"
            "import yolort_tpu_torch.tools.convert_yolov5_to_yolort\n"
            "import yolort_tpu_torch.tools.convert_txt_to_json\n"
            "import yolort_tpu_torch.parallel, yolort_tpu_torch.utils.metrics\n"
            "import yolort_tpu_torch.utils.boxes, yolort_tpu_torch.data.datasets\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'yolort_tpu')))\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"
