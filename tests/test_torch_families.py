"""The YOLOv5 families beside r6.0 (r3.1, r4.0, P6, TAN): the port against
the JAX package on the same weights, float32 on the CPU.

- At nano width (depth 0.33, width 0.25), random BatchNorm statistics and
  every other conv folded (``torch_parity.randomize_convs``), JAX params
  carried across by ``params_from_jax``: ``head_outputs`` and ``decode``
  within atol 1e-4 (the tolerance of tests/test_torch_model.py: the two
  frameworks' summation orders drift apart by ~1e-5 per conv).
- P6 postprocess: identical 4-level head logits give each route's
  Detections equal to the JAX cell path's on that route: count, valid,
  labels and order exactly, scores and boxes within rtol 1e-6, the
  tolerance of tests/test_torch_stage1.py (torch's and XLA's sigmoids
  may differ by 2 ulp; on this data they agree bit for bit).
- P6 int8: the JAX recipe's finalized tree gives identical int8 features
  and head logits within 1e-5 of the largest (tests/test_torch_quant.py);
  the port's own quantize and finalize on the same marks give the same
  leaves and scales.
- The registry holds the JAX package's 17 architectures, and every factory
  builds on the CPU.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolort_tpu_torch
from torch_parity import (
    copy_marks, port_int8_leaf, random_heads, randomize_convs, unwrap_static, walk_convs,
)
from yolort_tpu.models import head as JH
from yolort_tpu.models.yolo import ARCHS as JARCHS
from yolort_tpu.models.yolo import YOLO as JaxYOLO
from yolort_tpu.ops import nms as JN
from yolort_tpu.ops import quantization as JQ
from yolort_tpu_torch.models import head as TH
from yolort_tpu_torch.models._bridge import params_from_jax
from yolort_tpu_torch.models.yolo import ARCHS, YOLO
from yolort_tpu_torch.ops import nms as TN
from yolort_tpu_torch.ops import quantization as TQ
from yolort_tpu_torch.ops.blocks import Bottleneck, Conv, space_to_depth
from yolort_tpu_torch.ops.cuda.qconv_kernel import pack_weight

NANO = (0.33, 0.25)
# family: (YOLO keywords, image (H, W))
FAMILIES = {
    "r3.1": (dict(version="r3.1"), (96, 128)),
    "r4.0": (dict(version="r4.0"), (96, 128)),
    "p6": (dict(use_p6=True), (256, 256)),  # the stride-64 level has 4x4 cells
    "tan": (dict(version="r4.0", use_tan=True), (96, 128)),
}


def _numpy_init(jm, seed):
    """A params tree of ``jm.init``'s layout drawn with numpy: the backbone's
    and PAN's leaf shapes from ``jax.eval_shape`` (eager, JAX would compile
    every draw's shape on its own), the head's own init.  Weights U(-b, b),
    b = 1/sqrt(fan-in); BatchNorm at identity; biases small."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if len(leaf.shape) > 1:
            bound = 1.0 / np.sqrt(np.prod(leaf.shape[:-1]))
            return rng.uniform(-bound, bound, leaf.shape).astype(np.float32)
        if name in ("gamma", "var"):
            return np.ones(leaf.shape, np.float32)
        if name == "b":
            return rng.uniform(-0.1, 0.1, leaf.shape).astype(np.float32)
        return np.zeros(leaf.shape, np.float32)

    kb, kp, kh = jax.random.split(jax.random.PRNGKey(seed), 3)
    shapes = {"backbone": jax.eval_shape(jm.backbone.init, kb), "pan": jax.eval_shape(jm.pan.init, kp)}
    return {**jax.tree_util.tree_map_with_path(draw, shapes), "head": jm.head.init(kh)}


def _pair(name):
    """(JAX YOLO, its numpy params, the port YOLO on the CPU, a seeded
    image batch) of a family at nano width."""
    kw, hw = FAMILIES[name]
    jm = JaxYOLO(*NANO, **kw)
    params = randomize_convs(_numpy_init(jm, 7), 7)
    tm = params_from_jax(params, YOLO(*NANO, device="cpu", **kw))
    x = np.random.default_rng(1).random((2, *hw, 3)).astype(np.float32)
    return jm, params, tm, x


@pytest.fixture(scope="module")
def p6_pair():
    return _pair("p6")


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request, p6_pair):
    jm, params, tm, x = p6_pair if request.param == "p6" else _pair(request.param)
    want = jm.head_outputs(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm.head_outputs(torch.from_numpy(x))
    return request.param, jm, tm, x, [np.asarray(w) for w in want], got


def test_head_outputs_match_jax(family):
    name, jm, tm, x, want, got = family
    assert len(got) == (4 if name == "p6" else 3)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-4, rtol=0)


def test_decode_matches_jax(family):
    """``YOLO.decode`` against the JAX decode (``YOLO.decode`` is
    ``concat_pred_logits`` of its head outputs)."""
    name, jm, tm, x, want, _ = family
    jdec = np.asarray(JH.concat_pred_logits([jnp.asarray(w) for w in want],
                                            [w.shape[1:3] for w in want], jm.strides,
                                            jm.anchor_grids))
    with torch.no_grad():
        got = tm.decode(torch.from_numpy(x)).numpy()
    assert got.shape == jdec.shape == (2, jdec.shape[1], 85)
    # boxes are in canvas pixels: stride 64 times a 2e-5 sigmoid difference
    np.testing.assert_allclose(got[..., 4:], jdec[..., 4:], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got[..., :4], jdec[..., :4], atol=1e-4 * 64, rtol=1e-5)
    assert tm.strides == jm.strides and tm.anchor_grids == jm.anchor_grids


def test_space_to_depth_is_the_focus_channel_order():
    from yolort_tpu.ops.blocks import space_to_depth as jax_s2d

    x = np.random.default_rng(2).random((2, 6, 8, 3)).astype(np.float32)
    got = space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_s2d(jnp.asarray(x))))


P6_GRIDS = ((32, 32), (16, 16), (8, 8), (4, 4))
P6_CONFIGS = {
    "eval": dict(score_thresh=0.005, detections_per_img=300, pre_nms_topk=4096),
    "serving": dict(score_thresh=0.25, detections_per_img=300, pre_nms_topk=512),
}


@pytest.mark.parametrize("config", sorted(P6_CONFIGS))
@pytest.mark.parametrize("row_gather", ["pallas_bisect", "pallas_lookup", "pallas_full"])
def test_p6_detections_match_jax_on_every_route(row_gather, config):
    heads = random_heads(31, P6_GRIDS, shift=-1.0)
    kw = dict(num_classes=80, nms_thresh=0.45, **P6_CONFIGS[config])
    strides, anchors = JH.P6_STRIDES, JH.P6_ANCHOR_GRIDS
    want = jax.jit(lambda hs: JN.batched_postprocess_from_heads(
        hs, strides, anchors, flatten_pad="cell", topk_impl="bisect", nms_impl="xla",
        row_gather=row_gather, **kw,
    ))([jnp.asarray(h) for h in heads])
    got = TN.batched_postprocess_from_heads([torch.from_numpy(h) for h in heads], TH.P6_STRIDES,
                                            TH.P6_ANCHOR_GRIDS, row_gather=row_gather, **kw)
    assert (got.num.numpy() > 0).all()
    np.testing.assert_array_equal(got.num.numpy(), np.asarray(want.num))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-6, atol=1e-5)


@pytest.fixture(scope="module")
def p6_int8(p6_pair):
    """The P6 pair's JAX tree calibrated on its first image, quantized and
    finalized (the static-scale tree, and its numpy form for the port).
    One image throughout: JAX compiles each eager op once a shape."""
    jm, params, tm, x = p6_pair
    x = x[:1]
    pc = JQ.calibrate_activations(jm.head_outputs, params, [jnp.asarray(x)])
    jfin = JQ.finalize_scales(jm.head_outputs, JQ.quantize_compute_params(pc), x)
    return jm, pc, jfin, unwrap_static(jfin), tm, x


def test_p6_int8_features_and_logits_match_jax(p6_int8):
    jm, _, jfin, jf, _, x = p6_int8
    tq = params_from_jax(jf, YOLO(*NANO, device="cpu", use_p6=True))
    assert "p6" in jf["pan"]
    assert sum(isinstance(m, Conv) and m.quantized for m in tq.pan.p6.modules()) >= 3
    jfeats = jm.features(jfin, jnp.asarray(x))
    with torch.no_grad():
        tfeats = tq.features(torch.from_numpy(x))
    assert len(tfeats) == 4
    for j, t in zip(jfeats, tfeats):
        assert t.q.dtype == torch.int8 and t.s == j.s.v
        np.testing.assert_array_equal(t.q.permute(0, 2, 3, 1).numpy(), np.asarray(j.q))
    with torch.no_grad():
        got = tq.head(tfeats)
    for g, w in zip(got, jm.head(jfin["head"], jfeats)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_p6_int8_recipe_matches_jax(p6_int8):
    """The port's quantize_compute_params and finalize_scales on the JAX
    calibration marks: the same int8 leaves, and every scale of the
    finalized tree, the p6 blocks' and the 4-level PAN's concat groups
    included."""
    _, pc, _, jf, tm, x = p6_int8
    port = copy.deepcopy(tm)
    copy_marks(pc, port)
    tq = TQ.finalize_scales(TQ.quantize_compute_params(port), x)
    n = 0
    for path, node, mod in walk_convs(jf, tq):
        if isinstance(mod, Bottleneck):
            assert (mod.as_ is None) == ("as" not in node)
            continue
        assert mod.quantized == ("wq" in node), path
        if not mod.quantized:
            continue
        got = port_int8_leaf(mod)
        np.testing.assert_array_equal(got["wq"], pack_weight(np.asarray(node["wq"])).numpy())
        np.testing.assert_array_equal(got["ws"], node["ws"])
        assert got["xs"] == node["xs"] and got.get("os") == node.get("os"), path
        n += 1
    assert n >= 40


def test_registry_and_every_factory_build_on_the_cpu():
    assert set(ARCHS) == set(JARCHS) and len(ARCHS) == 17
    for name in ("yolov5n", "yolov5s", "yolov5m", "yolov5l", "yolov5x", "yolov5n6", "yolov5s6",
                 "yolov5m6", "yolov5l6", "yolov5x6", "yolov5ts"):
        m = getattr(yolort_tpu_torch, name)(device="cpu")
        assert m.model.num_anchors == 3 and m.device == torch.device("cpu")
        assert m.size_divisible == (64 if name.endswith("6") else 32)
        assert len(m.model.strides) == (4 if name.endswith("6") else 3)
    for version in ("r3.1", "r4.0"):
        m = yolort_tpu_torch.yolov5s(upstream_version=version, device="cpu")
        assert m.arch == f"yolov5_darknet_pan_s_{version.replace('.', '')}"
        assert m.model.version == version
    with pytest.raises(NotImplementedError):
        yolort_tpu_torch.yolov5n(upstream_version="r3.1", device="cpu")  # no nano before r6.0
    with pytest.raises(NotImplementedError):
        yolort_tpu_torch.yolov5ts(upstream_version="r6.0", device="cpu")
    if not torch.cuda.is_available():
        for build in (yolort_tpu_torch.yolov5s6, yolort_tpu_torch.yolov5ts):
            with pytest.raises(RuntimeError, match="CUDA device"):
                build()
