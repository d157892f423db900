"""The port's remaining utilities against the JAX package's, on the CPU, on
the same inputs:

- ``utils/general``, ``callbacks``, ``dependency`` and ``utils/__init__``'s
  exports: equal answers;
- ``utils/autoanchor``: ``kmean_anchors`` bit-equal for the same seed, the
  fitness metrics and ``check_anchor_order`` equal;
- ``utils/anchor_viz``: the same matches, bit-equal images, and the
  matches equal to the candidate lattice of the port's ``YOLOLoss``;
- ``utils/visualizer``, ``utils/plots.plot_images``: bit-equal images and
  files (``plot_pr_curve`` / ``plot_mc_curve`` write their files);
- ``data/voc``: the same targets and image;
- ``utils/hooks.FeatureExtractor``: JAX's names, values within 1e-4 on the
  tiny model of torch_parity (float32 convolutions in two frameworks), and
  no hook left on the model afterwards, on an exception too;
- ``utils/profiling``: ``model_info``'s parameter count equal to JAX's
  ``count_params``; the forward FLOPs at 640 within 3% of XLA's cost
  analysis (``FlopCounterMode`` counts the multiply-adds of convolutions
  and matmuls as 2 operations each; XLA's count adds the elementwise work:
  activations, residual adds, upsampling; 1.5% apart on this model);
  ``time_sync``, ``trace`` and ``device_memory_stats`` on the CPU;
- a fresh process that imports every module added by this slice holds
  neither ``jax`` nor ``yolort_tpu``.
"""

import json
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import port_to_nhwc, tiny_pair
from yolort_tpu.models.head import DEFAULT_ANCHOR_GRIDS, DEFAULT_STRIDES
from yolort_tpu.utils import anchor_viz as JAV
from yolort_tpu.utils import autoanchor as JAA
from yolort_tpu.utils import callbacks as JCB
from yolort_tpu.utils import dependency as JDP
from yolort_tpu.utils import general as JG
from yolort_tpu_torch.models.losses import YOLOLoss
from yolort_tpu_torch.utils import anchor_viz as AV
from yolort_tpu_torch.utils import autoanchor as AA
from yolort_tpu_torch.utils import callbacks as CB
from yolort_tpu_torch.utils import dependency as DP
from yolort_tpu_torch.utils import general as G

ROOT = Path(__file__).resolve().parent.parent
NEW_MODULES = (
    "yolort_tpu_torch.utils.robustness", "yolort_tpu_torch.utils.profiling",
    "yolort_tpu_torch.utils.hooks", "yolort_tpu_torch.utils.general",
    "yolort_tpu_torch.utils.callbacks", "yolort_tpu_torch.utils.dependency",
    "yolort_tpu_torch.utils.autoanchor", "yolort_tpu_torch.utils.anchor_viz",
    "yolort_tpu_torch.utils.plots", "yolort_tpu_torch.utils.visualizer",
    "yolort_tpu_torch.data.voc", "yolort_tpu_torch.tools.profile_stages",
    "yolort_tpu_torch.tools.regression", "yolort_tpu_torch.models._checkpoint",
)


# --- general, callbacks, dependency ----------------------------------------

def test_general_matches_jax(tmp_path):
    for x, d in ((97, 32), (640, 32), (641, 32), (3.5, 8), (0, 64)):
        assert G.make_divisible(x, d) == JG.make_divisible(x, d)
    for size, s, floor in ((640, 32, 0), (641, 32, 0), ([640, 641], 32, 0), (10, 32, 64),
                           ([100, 7], 64, 128)):
        assert G.check_img_size(size, s, floor) == JG.check_img_size(size, s, floor)
    for args in (("hello",), ("red", "bold", "x"), ("nope", 3)):
        assert G.colorstr(*args) == JG.colorstr(*args)
    cycle, jcycle = G.one_cycle(0.1, 1.0, 50), JG.one_cycle(0.1, 1.0, 50)
    assert [cycle(i) for i in range(51)] == [jcycle(i) for i in range(51)]
    p = tmp_path / "exp"
    p.mkdir()
    (tmp_path / "exp2").mkdir()
    for kw in ({}, {"exist_ok": True}, {"sep": "_"}):
        assert G.increment_path(str(p), **kw) == JG.increment_path(str(p), **kw)
    made = G.increment_path(str(tmp_path / "run" / "a.txt"), mkdir=True)
    assert made == tmp_path / "run" / "a.txt" and made.parent.is_dir()
    G.init_seeds(3)
    a = np.random.rand(4)
    JG.init_seeds(3)
    assert (a == np.random.rand(4)).all()


def test_callbacks_match_jax():
    assert CB.EVENTS == JCB.EVENTS
    cb = CB.Callbacks()
    seen = []
    cb.register_action("on_train_start", "logger", lambda **kw: seen.append(kw))
    cb.run("on_train_start", epoch=0)
    assert seen == [{"epoch": 0}]
    for bad in (lambda: cb.register_action("bogus_hook", callback=lambda: None),
                lambda: cb.register_action("on_train_start", callback="not callable"),
                lambda: cb.run("bogus_hook")):
        with pytest.raises(ValueError):
            bad()
    assert len(cb.get_registered_actions("on_train_start")) == 1
    assert sorted(cb.get_registered_actions()) == sorted(JCB.Callbacks().get_registered_actions())


def test_dependency_matches_jax():
    for cur, mn in (("2.1.0", "2.0"), ("v1.9", "1.10"), ("2.13.0+cpu", "2.13.0"),
                    ("1.0rc1", "1.0.1"), ("3", "3.0.0")):
        assert DP.check_version(cur, mn) == JDP.check_version(cur, mn)
    for name in ("numpy", "surely_not_a_module_xyz"):
        assert DP.is_module_available(name) == JDP.is_module_available(name)

    @DP.requires_module("surely_not_a_module_xyz")
    def needs():
        return 1

    @DP.requires_module("numpy")
    def has():
        return 2

    with pytest.raises(RuntimeError, match="surely_not_a_module_xyz"):
        needs()
    assert has() == 2

    @DP.deprecated("use another")
    def old():
        return 3

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert old() == 3
    assert caught and issubclass(caught[0].category, DeprecationWarning)


def test_utils_exports():
    import yolort_tpu.utils as JU
    import yolort_tpu_torch.utils as U

    assert U.__all__ == [n for n in JU.__all__ if n != "tpu_compiler_options"]
    model = torch.nn.Linear(3, 2)
    assert U.count_params(model) == 8 and U.cast_floating(model, torch.bfloat16) is model
    assert U.check_version is DP.check_version and U.requires_module is DP.requires_module


# --- autoanchor -------------------------------------------------------------

def label_whs(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.normal(20, 2, (100, 2)), rng.normal(80, 5, (100, 2)),
                           rng.normal(200, 10, (100, 2))]).clip(1.5)


@pytest.mark.parametrize("seed,n", [(0, 3), (1, 9)])
def test_kmean_anchors_bit_equal_jax(seed, n):
    wh = label_whs(seed)
    got = AA.kmean_anchors(wh, n=n, gen=200, seed=seed)
    np.testing.assert_array_equal(got, JAA.kmean_anchors(wh, n=n, gen=200, seed=seed))
    assert got.shape == (n, 2) and (np.diff(got.prod(1)) > 0).all()
    grids = [tuple(got.reshape(-1))]
    assert AA.check_anchors(wh, grids) == JAA.check_anchors(wh, grids)
    assert AA.check_anchors(wh, DEFAULT_ANCHOR_GRIDS) == JAA.check_anchors(wh, DEFAULT_ANCHOR_GRIDS)
    assert AA.check_anchors(wh, grids, thr=2.0)[0] <= AA.check_anchors(wh, grids)[0]
    with pytest.raises(ValueError):
        AA.kmean_anchors(wh[:2], n=n)


def test_anchor_fitness_and_order_match_jax():
    wh = label_whs(2)
    anchors = np.asarray(DEFAULT_ANCHOR_GRIDS[0], np.float64).reshape(-1, 2)
    assert AA.anchor_fitness_metric(wh, anchors) == JAA.anchor_fitness_metric(wh, anchors)
    for grids, strides in (([(100, 100, 120, 120, 140, 140), (10, 10, 12, 12, 14, 14)], [8, 16]),
                           (DEFAULT_ANCHOR_GRIDS, DEFAULT_STRIDES)):
        got = AA.check_anchor_order(grids, strides)
        assert got == JAA.check_anchor_order(grids, strides)
        assert got[0][0] < got[-1][0]


# --- anchor_viz -------------------------------------------------------------

# centres off the grid lines of every level at both image sizes
BOXES = np.asarray([[0.53, 0.41, 0.25, 0.3], [0.503, 0.497, 0.2, 0.2],
                    [0.1013, 0.8987, 0.05, 0.08], [0.77, 0.22, 0.6, 0.5]])


def loss_lattice(boxes, hw):
    """Per level, the sorted flat (cell * A + anchor) indices of the port's
    ``YOLOLoss`` candidates of one image's targets ``boxes``."""
    loss = YOLOLoss(strides=DEFAULT_STRIDES, anchor_grids=DEFAULT_ANCHOR_GRIDS, num_classes=2)
    targets = torch.from_numpy(np.concatenate([np.zeros((len(boxes), 1)), boxes], 1)
                               .astype(np.float32))[None]
    mask = torch.ones(1, len(boxes), dtype=torch.bool)
    out = []
    for stride, ag in zip(DEFAULT_STRIDES, DEFAULT_ANCHOR_GRIDS):
        c = loss._candidates((1, hw[0] // stride, hw[1] // stride), stride, ag, targets, mask)
        out.append(sorted(c["cell"][0][c["c_mask"][0]].tolist()))
    return out


def flat_cells(level, w: int, na: int = 3):
    return sorted((m["cell"][1] * w + m["cell"][0]) * na + m["anchor"] for m in level)


@pytest.mark.parametrize("hw", [(640, 640), (128, 192)])
def test_anchor_matches_equal_jax_and_the_loss_lattice(hw):
    matches = AV.compute_anchor_matches(BOXES, DEFAULT_STRIDES, DEFAULT_ANCHOR_GRIDS, hw)
    assert matches == JAV.compute_anchor_matches(BOXES, DEFAULT_STRIDES, DEFAULT_ANCHOR_GRIDS, hw)
    assert sum(len(level) for level in matches) > 0
    for stride, level, lattice in zip(DEFAULT_STRIDES, matches, loss_lattice(BOXES, hw)):
        assert flat_cells(level, hw[1] // stride) == lattice


def test_anchor_matches_on_a_grid_line_are_the_kept_quirk():
    """A centre on a grid line (fraction 0) takes all five cells in both;
    the loss's right and lower neighbours are floor(g + 0.5), the centre
    cell itself, where anchor_viz (a copy of JAX's) draws the next cell."""
    box = np.asarray([[0.5, 0.5, 0.2, 0.2]])
    matches = AV.compute_anchor_matches(box, DEFAULT_STRIDES, DEFAULT_ANCHOR_GRIDS, (640, 640))
    assert matches == JAV.compute_anchor_matches(box, DEFAULT_STRIDES, DEFAULT_ANCHOR_GRIDS,
                                                 (640, 640))
    for stride, level, lattice in zip(DEFAULT_STRIDES, matches, loss_lattice(box, (640, 640))):
        g = 320 // stride
        moved = [dict(m, cell=(min(m["cell"][0], g), min(m["cell"][1], g))) for m in level]
        assert flat_cells(moved, 640 // stride) == lattice
        assert len(level) == len(lattice)


def test_anchor_match_visualize_bit_equal_jax():
    img = np.random.default_rng(0).uniform(0, 1, (128, 160, 3)).astype(np.float32)
    labels = np.arange(len(BOXES))
    got = AV.anchor_match_visualize(img, BOXES, labels, DEFAULT_STRIDES, DEFAULT_ANCHOR_GRIDS)
    want = JAV.anchor_match_visualize(img, BOXES, labels, DEFAULT_STRIDES, DEFAULT_ANCHOR_GRIDS)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (128, 160, 3)
        np.testing.assert_array_equal(g, w)


# --- visualizer and plots -----------------------------------------------------

PRED = {"boxes": np.asarray([[5.0, 5.0, 30.0, 30.0], [10.5, 2.0, 55.0, 40.0]]),
        "scores": np.asarray([0.9, 0.4]), "labels": np.asarray([0, 3])}


@pytest.mark.parametrize("metalabels", [None, ["thing", "other", "x", "y"], "file"])
def test_visualizer_bit_equal_jax(tmp_path, metalabels):
    from yolort_tpu.utils.visualizer import Visualizer as JVisualizer
    from yolort_tpu_torch.utils.visualizer import Visualizer

    if metalabels == "file":
        metalabels = tmp_path / "names.txt"
        metalabels.write_text("cat\n\ndog\nbird\nfish\n")
    img = np.random.default_rng(1).uniform(0, 1, (50, 60, 3)).astype(np.float32)
    vis, jvis = Visualizer(img, metalabels), JVisualizer(img, metalabels)
    assert vis.class_names == jvis.class_names
    np.testing.assert_array_equal(vis.draw_instance_predictions(PRED),
                                  jvis.draw_instance_predictions(PRED))
    gt = {"boxes": PRED["boxes"][::-1], "labels": PRED["labels"][::-1]}
    np.testing.assert_array_equal(vis.draw_ground_truth(gt), jvis.draw_ground_truth(gt))
    vis.save(str(tmp_path / "a.png"))
    jvis.save(str(tmp_path / "b.png"))
    assert (tmp_path / "a.png").read_bytes() == (tmp_path / "b.png").read_bytes()


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_plot_images_bit_equal_jax(tmp_path, dtype):
    from yolort_tpu.utils.plots import plot_images as jplot_images
    from yolort_tpu_torch.utils.plots import plot_images

    rng = np.random.default_rng(0)
    imgs = rng.uniform(0, 1, (5, 32, 48, 3)).astype(np.float32)
    if dtype == np.uint8:
        imgs = (imgs * 255).astype(np.uint8)
    targets = np.asarray([[0, 1, 0.5, 0.5, 0.4, 0.4], [2, 0, 0.3, 0.3, 0.2, 0.2],
                          [4, 95, 0.6, 0.4, 0.3, 0.5]])
    paths = [f"dir/img_{i}.jpg" for i in range(5)]
    got = plot_images(imgs, targets, paths, fname=str(tmp_path / "a.jpg"))
    want = jplot_images(imgs, targets, paths, fname=str(tmp_path / "b.jpg"))
    assert got.shape == (96, 144, 3)
    np.testing.assert_array_equal(got, want)
    assert (tmp_path / "a.jpg").read_bytes() == (tmp_path / "b.jpg").read_bytes()
    np.testing.assert_array_equal(plot_images(imgs, None, fname="", max_subplots=4),
                                  jplot_images(imgs, None, fname="", max_subplots=4))


def test_pr_curves_write_files(tmp_path):
    from yolort_tpu_torch.utils.plots import plot_mc_curve, plot_pr_curve

    x = np.linspace(0, 1, 101)
    plot_pr_curve(x, {"all": 1 - x * 0.5}, fname=str(tmp_path / "pr.png"))
    plot_mc_curve(x, {"F1": x * (1 - x) * 4}, fname=str(tmp_path / "f1.png"))
    assert (tmp_path / "pr.png").stat().st_size > 0 and (tmp_path / "f1.png").stat().st_size > 0


# --- VOC ----------------------------------------------------------------------

VOC_XML = """<annotation><size><width>120</width><height>100</height><depth>3</depth></size>
  <object><name>dog</name><difficult>0</difficult>
    <bndbox><xmin>11</xmin><ymin>21</ymin><xmax>61</xmax><ymax>81</ymax></bndbox></object>
  <object><name>Person </name><difficult>1</difficult>
    <bndbox><xmin>1</xmin><ymin>1</ymin><xmax>10</xmax><ymax>10</ymax></bndbox></object>
  <object><name>unicorn</name>
    <bndbox><xmin>5</xmin><ymin>5</ymin><xmax>20</xmax><ymax>20</ymax></bndbox></object>
  <object><name>car</name>
    <bndbox><xmin>100</xmin><ymin>50</ymin><xmax>130</xmax><ymax>101</ymax></bndbox></object>
</annotation>"""


@pytest.mark.parametrize("layout", ["flat", "year"])
def test_voc_matches_jax(tmp_path, layout):
    import cv2

    from yolort_tpu.data.voc import VOCDetection as JVOC
    from yolort_tpu_torch.data.voc import VOC_CLASSES, VOCDetection
    from yolort_tpu.data.voc import VOC_CLASSES as J_VOC_CLASSES

    base = tmp_path if layout == "flat" else tmp_path / "VOC2007"
    (base / "JPEGImages").mkdir(parents=True)
    (base / "Annotations").mkdir()
    rng = np.random.default_rng(0)
    for stem in ("0001", "0002"):
        cv2.imwrite(str(base / "JPEGImages" / f"{stem}.jpg"),
                    rng.integers(0, 255, (100, 120, 3), dtype=np.uint8))
        (base / "Annotations" / f"{stem}.xml").write_text(VOC_XML)
    if layout == "year":
        (base / "ImageSets" / "Main").mkdir(parents=True)
        (base / "ImageSets" / "Main" / "val.txt").write_text("0002\n")
    kw = dict(image_set="val", year="2007") if layout == "year" else {}
    assert VOC_CLASSES == J_VOC_CLASSES
    for keep in (False, True):
        ds, jds = VOCDetection(str(tmp_path), keep_difficult=keep, **kw), \
            JVOC(str(tmp_path), keep_difficult=keep, **kw)
        assert ds.ids == jds.ids and len(ds) == (2 if layout == "flat" else 1)
        img, tgt = ds[0]
        jimg, jtgt = jds[0]
        np.testing.assert_array_equal(img, jimg)
        assert sorted(tgt) == sorted(jtgt)
        for k in tgt:
            np.testing.assert_array_equal(tgt[k], jtgt[k])
        assert len(tgt["labels"]) == (3 if keep else 2)
    np.testing.assert_array_equal(tgt["boxes"][0], [10, 20, 60, 80])


# --- FeatureExtractor ---------------------------------------------------------

def no_hooks(module) -> bool:
    return all(not m._forward_hooks for m in module.modules())


@pytest.mark.parametrize("return_layers", [("backbone", "pan", "head"), ("pan",), ("head",)])
def test_feature_extractor_matches_jax(return_layers):
    from yolort_tpu.utils.hooks import FeatureExtractor as JFeatureExtractor
    from yolort_tpu_torch.utils.hooks import FeatureExtractor

    jm, params, tm = tiny_pair(0)
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    want = JFeatureExtractor(jm, return_layers)(params, jnp.asarray(x))
    before = [o.clone() for o in tm.head_outputs(torch.from_numpy(x))]
    got = FeatureExtractor(tm, return_layers)(torch.from_numpy(x))
    assert list(got) == list(want)
    for name, w in want.items():
        g = got[name].detach()
        g = g.numpy() if name.startswith("head") else port_to_nhwc(g)
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=name)
    assert no_hooks(tm)
    after = tm.head_outputs(torch.from_numpy(x))
    assert all(torch.equal(a, b) for a, b in zip(after, before))


def test_feature_extractor_removes_its_hooks_on_an_exception():
    from yolort_tpu_torch.utils.hooks import FeatureExtractor

    _, _, tm = tiny_pair(0)
    with pytest.raises(RuntimeError):
        FeatureExtractor(tm)(torch.zeros(1, 64, 64, 5))  # 5 channels: the stem refuses
    assert no_hooks(tm)


# --- profiling ----------------------------------------------------------------

def test_model_info_matches_jax():
    from yolort_tpu.utils import count_params as jcount_params
    from yolort_tpu.utils.ir_visualizer import cost_analysis
    from yolort_tpu_torch.utils.profiling import forward_flops, model_info

    jm, params, tm = tiny_pair(0)
    info = model_info(tm)
    n = sum(p.numel() for p in tm.parameters())
    assert n == jcount_params(params)
    assert info.startswith(f"params: {n / 1e6:.2f}M") and "forward FLOPs @640" in info
    xla = cost_analysis(lambda p, x: jm.head_outputs(p, x), params,
                        jnp.zeros((1, 640, 640, 3), jnp.float32))["flops"]
    assert abs(forward_flops(tm, 640) / xla - 1) < 0.03


def test_time_sync_trace_and_memory_stats_on_the_cpu(tmp_path):
    from yolort_tpu_torch.utils.profiling import device_memory_stats, time_sync, trace

    t0 = time_sync("cpu")
    t1 = time_sync(torch.device("cpu"))
    assert t1 >= t0 and time_sync() >= t1
    _, _, tm = tiny_pair(0)
    with trace(str(tmp_path / "tr")) as prof:
        tm.head_outputs(torch.zeros(1, 64, 64, 3))
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    assert any("conv" in e.key for e in prof.key_averages())
    assert device_memory_stats() == {}  # no card in this process


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = ("import sys\n"
            f"for m in {NEW_MODULES!r}: __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'yolort_tpu'))\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
