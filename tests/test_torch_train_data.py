"""The port's training data path (``yolort_tpu_torch.data``,
``utils.logger``, ``trainer.hyp``) against the JAX package's.  Both are
numpy (and cv2 where an image is read, drawn or colour-shifted), so every
result is held exactly, but for images that the letterbox resizes: the
port's numpy resize is within 2e-3 of the JAX package's cv2 one."""

import json

import numpy as np
import pytest

from yolort_tpu.data import _helper as jhelper
from yolort_tpu.data import coco as jcoco
from yolort_tpu.data import coco_eval as jeval
from yolort_tpu.data import data_module as jdm
from yolort_tpu.data import transforms as jtf
from yolort_tpu.trainer import hyp as jhyp
from yolort_tpu.utils import logger as jlogger
from yolort_tpu_torch.data import _helper as thelper
from yolort_tpu_torch.data import coco as tcoco
from yolort_tpu_torch.data import coco_eval as teval
from yolort_tpu_torch.data import data_module as tdm
from yolort_tpu_torch.data import transforms as ttf
from yolort_tpu_torch.trainer import hyp as thyp
from yolort_tpu_torch.utils import logger as tlogger


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """One create_synthetic_coco set per package, same arguments."""
    root = tmp_path_factory.mktemp("synthetic")
    kw = dict(num_images=6, num_classes=3, image_hw=(120, 160), seed=4)
    return (jhelper.create_synthetic_coco(str(root / "jax"), **kw),
            thelper.create_synthetic_coco(str(root / "port"), **kw))


def _equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal(x, y, f"{path}/{i}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)


def test_create_synthetic_coco_matches_jax(synthetic):
    (jimg, jann), (timg, tann) = synthetic
    with open(jann) as f, open(tann) as g:
        assert json.load(f) == json.load(g)
    jds, tds = jcoco.COCODetection(jimg, jann), tcoco.COCODetection(timg, tann)
    assert len(jds) == len(tds) == 6
    for i in range(len(jds)):
        _equal(jds[i], tds[i], f"item {i}")
    assert jds.contiguous_category_id_to_json_id == tds.contiguous_category_id_to_json_id
    assert jhelper.create_small_table({"AP": 0.5, "n": 3}) == \
        thelper.create_small_table({"AP": 0.5, "n": 3})


@pytest.mark.parametrize("canvas,shuffle", [((128, 160), False), ((96, 128), True)])
def test_detection_data_module_batches_match_jax(synthetic, canvas, shuffle):
    """(128, 160): the 120x160 frames are not resized, so every array is
    equal; (96, 128): resized, the images within 2e-3, the rest equal."""
    (jimg, jann), (timg, tann) = synthetic
    h, w = canvas
    kw = dict(batch_size=4, canvas_hw=canvas, min_size=h, max_size=w, max_targets_per_image=5,
              shuffle=shuffle, seed=3)
    jd = jdm.DetectionDataModule(jcoco.COCODetection(jimg, jann), **kw)
    td = tdm.DetectionDataModule(tcoco.COCODetection(timg, tann), **kw)
    jb, tb = list(jd.batches()), list(td.batches())
    assert len(jd) == len(td) == len(jb) == len(tb) == 2
    for a, b in zip(jb, tb):
        if canvas == (128, 160):
            _equal(a, b)
            continue
        np.testing.assert_allclose(b["images"], a["images"], rtol=0, atol=2e-3)
        _equal({k: v for k, v in a.items() if k != "images"},
               {k: v for k, v in b.items() if k != "images"})


@pytest.mark.parametrize("use_hyp", [False, True])
def test_default_train_transforms_match_jax(synthetic, use_hyp):
    (jimg, jann), (timg, tann) = synthetic
    hyp = dict(jhyp.DEFAULT_HYP, degrees=5.0, shear=2.0, flipud=0.5, cutout=0.5,
               copy_paste=0.5) if use_hyp else None
    jds = jcoco.COCODetection(jimg, jann, transforms=jtf.default_train_transforms(7, hyp))
    tds = tcoco.COCODetection(timg, tann, transforms=ttf.default_train_transforms(7, hyp))
    plain = tcoco.COCODetection(timg, tann)
    changed = 0
    for i in range(len(jds)):
        got = tds[i]  # each read draws from the stack's generators
        _equal(jds[i], got, f"augmented item {i}")
        changed += not np.array_equal(got[0], plain[i][0])
    assert changed  # the stack did augment


def _eval_case(seed: int):
    rng = np.random.default_rng(seed)
    preds, tgts = [], []
    for _ in range(5):
        g = rng.integers(0, 6)
        gxy = rng.uniform(0, 300, (g, 2))
        gt = np.concatenate([gxy, gxy + rng.uniform(10, 150, (g, 2))], 1).astype(np.float32)
        d = rng.integers(0, 12)
        jitter = rng.normal(0, 8, (d, 4)).astype(np.float32)
        base = gt[rng.integers(0, g, d)] if g else np.zeros((d, 4), np.float32)
        boxes = base + jitter
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
        preds.append({"boxes": boxes, "scores": rng.random(d).astype(np.float32),
                      "labels": rng.integers(0, 3, d)})
        tgts.append({"boxes": gt, "labels": rng.integers(0, 3, g),
                     "iscrowd": (rng.random(g) < 0.15).astype(np.int64)})
    return preds, tgts


@pytest.mark.parametrize("seed", [0, 1])
def test_coco_evaluator_matches_jax(seed):
    preds, tgts = _eval_case(seed)
    je, te = jeval.COCOEvaluator(), teval.COCOEvaluator()
    for ev in (je, te):
        ev.update(preds[:3], tgts[:3])
        ev.update(preds[3:], tgts[3:])
        ev.synchronize_between_processes()
    jr, tr = je.compute(), te.compute()
    assert jr.keys() == tr.keys() and 0 < tr["AP50"] < 1
    np.testing.assert_array_equal(np.asarray(list(tr.values())), np.asarray(list(jr.values())))
    assert te.per_class_ap.keys() == je.per_class_ap.keys()
    np.testing.assert_array_equal(list(te.per_class_ap.values()), list(je.per_class_ap.values()))


def test_metric_logger_matches_jax(capsys):
    values = [3.0, 1.0, 2.0, 5.0, 4.0]
    jm, tm = jlogger.MetricLogger(), tlogger.MetricLogger()
    for v in values:
        jm.update(loss=v, total=2 * v)
        tm.update(loss=v, total=2 * v)
    assert str(tm) == str(jm)
    for name in ("median", "avg", "global_avg", "value"):
        assert getattr(tm.loss, name) == getattr(jm.loss, name)
    tm.synchronize_between_processes()
    assert tm.loss.total == jm.loss.total == sum(values)
    assert list(tm.log_every(range(3), 1, header="h")) == [0, 1, 2]
    assert "h Total time" in capsys.readouterr().out


def test_hyp_matches_jax(tmp_path):
    assert thyp.DEFAULT_HYP == jhyp.DEFAULT_HYP
    path = tmp_path / "hyp.yaml"
    path.write_text("lr0: 0.02\nfl_gamma: 1.5\ncustom: 3\n")
    assert thyp.load_hyp(str(path)) == jhyp.load_hyp(str(path))
    assert thyp.load_hyp() == jhyp.load_hyp()
    bad = tmp_path / "bad.yaml"
    bad.write_text("- 1\n- 2\n")
    with pytest.raises(ValueError, match="mapping"):
        thyp.load_hyp(str(bad))
