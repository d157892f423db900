"""The port's int8-compute recipe and int8 glue against the JAX package,
float32 on the CPU.

- The int8 glue (``quantize_int8``, ``_qconcat``, ``_qadd``, the int8
  pool and upsample) against the JAX static-scale branches: identical
  int8 and identical scales.
- ``quantize_tensor_per_channel`` identical; ``quantize_compute_params``
  on the same calibration marks gives the same leaves; ``finalize_scales``
  finds the same concat groups and gives the same scale values.
- ``calibrate_activations`` on the port's own forward records the JAX
  ranges within rtol 1e-5: the float networks differ by summation order
  (~1e-5 of a logit after some sixty convs, tests/test_torch_model.py).
- The slice at nano width: the JAX recipe's finalized tree carried into the
  port with ``params_from_jax`` gives identical int8 features, head logits
  within the tolerance stated at the test, and the same serving-config
  detections through ``YOLOv5.__call__``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    MARKS, copy_marks, nhwc_to_port, port_int8_leaf, port_to_nhwc, randomize_convs,
    shift_head_bias, tiny_pair, unwrap_static, walk_convs,
)
from yolort_tpu.models import transform as JT
from yolort_tpu.models.yolo import YOLO as JaxYOLO
from yolort_tpu.ops import blocks as JB
from yolort_tpu.ops import nms as JN
from yolort_tpu.ops import quantization as JQ
from yolort_tpu_torch.models._bridge import params_from_jax
from yolort_tpu_torch.models.yolo import YOLO
from yolort_tpu_torch.models.yolov5 import YOLOv5
from yolort_tpu_torch.ops import blocks as TB
from yolort_tpu_torch.ops import quantization as TQ
from yolort_tpu_torch.ops.blocks import Bottleneck, Conv, Conv2dOnly
from yolort_tpu_torch.ops.cuda.qconv_kernel import pack_weight, quantize_int8

F32 = jnp.zeros((0,), jnp.float32)


def _q(seed, shape=(2, 6, 5, 8)):
    return np.random.default_rng(seed).integers(-127, 128, shape, dtype=np.int8)


def _pair(q, s):
    """The same int8 tensor as a JAX (NHWC) and a port (channels_last) QTensor."""
    return (JB.QTensor(jnp.asarray(q), JB.StaticScale(s), F32),
            TB.QTensor(nhwc_to_port(q).contiguous(memory_format=torch.channels_last), s,
                       torch.float32))


def _same(jq, tq):
    assert isinstance(tq, TB.QTensor) and tq.q.dtype == torch.int8
    assert tq.s == jq.s.v
    np.testing.assert_array_equal(port_to_nhwc(tq.q), np.asarray(jq.q))


# --- int8 glue ----------------------------------------------------------

def test_quantize_input_rounds_half_to_even_as_jax():
    s = 0.0125
    x = (np.arange(-300, 301, dtype=np.float32) * (s / 2)).reshape(1, 1, 1, -1)
    x = np.concatenate([x, np.random.default_rng(0).uniform(-2, 2, x.shape).astype(np.float32)])
    want = np.asarray(JB._quantize_input(jnp.asarray(x), 1.0 / s))
    np.testing.assert_array_equal(want, np.asarray(JB._requantize(jnp.asarray(x), JB.StaticScale(s)).q))
    got = quantize_int8(nhwc_to_port(x), 1.0 / s)
    np.testing.assert_array_equal(port_to_nhwc(got), want)


@pytest.mark.parametrize("scales", [(0.02, 0.02), (0.02, 0.013, 0.017, 0.02)])
def test_qconcat_matches_jax(scales):
    pairs = [_pair(_q(i), s) for i, s in enumerate(scales)]
    want = JB._qconcat([j for j, _ in pairs], axis=-1)
    got = TB._qconcat([t for _, t in pairs])
    _same(want, got)
    assert got.q.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("out_scale", [0.03, None])
def test_qadd_matches_jax(out_scale):
    (ja, ta), (jb, tb) = _pair(_q(1), 0.02), _pair(_q(2), 0.013)
    want = JB._qadd(ja, jb, None if out_scale is None else JB.StaticScale(out_scale))
    _same(want, TB._qadd(ta, tb, out_scale))
    # float operands take the float add
    x = np.random.default_rng(3).standard_normal((2, 6, 5, 8)).astype(np.float32)
    np.testing.assert_allclose(port_to_nhwc(TB._qadd(nhwc_to_port(x), tb)),
                               np.asarray(JB._qadd(jnp.asarray(x), jb)), rtol=1e-6)


def test_int8_pool_upsample_and_dequantize_match_jax():
    jq, tq = _pair(_q(4, (2, 7, 9, 16)), 0.021)
    want = JB.QTensor(JB.max_pool_same(jq.q, 5), jq.s, jq.ref)
    _same(want, TB._pool5(tq))
    _same(JB.upsample2x(jq), TB.upsample2x(tq))
    assert TB.upsample2x(tq).q.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(port_to_nhwc(TB._as_float(tq)), np.asarray(JB._as_float(jq)))


def test_int8_buffers_stay_float32_under_a_dtype_cast():
    conv = Conv2dOnly(32, 16, 1, gen=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(5)
    ws = rng.uniform(1e-4, 1e-3, 16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    conv.set_int8(rng.integers(-127, 128, (1, 1, 32, 16), dtype=np.int8), ws, 0.01, None, b)
    conv.to(torch.bfloat16)
    assert conv.wq.dtype == torch.int8
    np.testing.assert_array_equal(conv.ws_bits.view(torch.float32).numpy(), ws)
    np.testing.assert_array_equal(conv.b_bits.view(torch.float32).numpy(), b)


# --- the recipe -----------------------------------------------------------

def test_quantize_tensor_per_channel_matches_jax():
    w = np.random.default_rng(6).standard_normal((3, 3, 8, 5)).astype(np.float32)
    w[..., 2] = 0.0  # a dead channel keeps scale 1
    for axis in (-1, 0):
        for a, b in zip(TQ.quantize_tensor_per_channel(w, axis), JQ.quantize_tensor_per_channel(w, axis)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def calibrated():
    """Tiny JAX and port models on the same weights, and the JAX tree
    calibrated on two seeded batches."""
    jm, params, tm = tiny_pair(seed=5)
    rng = np.random.default_rng(0)
    batches = [rng.random((2, 64, 96, 3)).astype(np.float32) for _ in range(2)]
    pc = JQ.calibrate_activations(jm.head_outputs, params, [jnp.asarray(b) for b in batches])
    return jm, params, pc, tm, batches


def test_calibration_ranges_match_jax(calibrated):
    jm, params, pc, tm, batches = calibrated
    port = copy.deepcopy(tm)
    TQ.calibrate_activations(port, [torch.from_numpy(b) for b in batches])
    n = 0
    for path, node, mod in walk_convs(pc, port):
        for key in MARKS:
            assert (key in node) == hasattr(mod, key), (path, key)
            if key in node:
                np.testing.assert_allclose(getattr(mod, key), float(node[key]), rtol=1e-5,
                                           err_msg=str(path))
                n += 1
    assert n >= 60


def test_strip_calibration_drops_the_marks(calibrated):
    _, _, _, tm, batches = calibrated
    port = copy.deepcopy(tm)
    x = torch.from_numpy(batches[0])
    with torch.no_grad():
        before = port.head_outputs(x)
    TQ.calibrate_activations(port, [x])
    assert any(hasattr(m, "_absmax") for m in port.modules())
    assert TQ.strip_calibration(port) is port
    assert not any(hasattr(m, k) for m in port.modules() for k in MARKS)
    with torch.no_grad():
        for a, b in zip(before, port.head_outputs(x)):
            assert torch.equal(a, b)


def test_calibration_of_a_bfloat16_model_runs_in_float32(calibrated):
    """A bfloat16 model is calibrated on a float32 copy and keeps its dtype;
    its marks are those of that copy calibrated directly."""
    _, _, _, tm, batches = calibrated
    bf = copy.deepcopy(tm).to(torch.bfloat16)
    as_f32 = copy.deepcopy(bf).float()
    x = [torch.from_numpy(batches[0])]
    TQ.calibrate_activations(bf, x)
    TQ.calibrate_activations(as_f32, x)
    assert all(p.dtype == torch.bfloat16 for p in bf.parameters())
    pairs = list(zip(bf.modules(), as_f32.modules()))
    assert sum(hasattr(a, "_absmax") for a, _ in pairs) >= 60
    for a, b in pairs:
        for key in MARKS:
            assert getattr(a, key, None) == getattr(b, key, None)


def _quantized_pair(calibrated):
    """JAX quantize_compute_params and the port's on the same marks."""
    jm, params, pc, tm, _ = calibrated
    port = copy.deepcopy(tm)
    copy_marks(pc, port)
    return JQ.quantize_compute_params(pc), TQ.quantize_compute_params(port)


def test_quantize_compute_params_matches_jax(calibrated):
    jq, tq = _quantized_pair(calibrated)
    counts = {"int8": 0, "float": 0, "as": 0}
    for path, node, mod in walk_convs(jq, tq):
        assert not any(hasattr(mod, k) for k in MARKS)
        if isinstance(mod, Bottleneck):
            assert (mod.as_ is None) == ("as" not in node)
            if "as" in node:
                assert mod.as_ == float(node["as"])
                counts["as"] += 1
            continue
        assert mod.quantized == ("wq" in node), path
        if not mod.quantized:
            counts["float"] += 1
            continue
        counts["int8"] += 1
        got = port_int8_leaf(mod)
        np.testing.assert_array_equal(got["wq"], pack_weight(np.asarray(node["wq"])).numpy())
        np.testing.assert_array_equal(got["ws"], np.asarray(node["ws"]))
        np.testing.assert_array_equal(got["b"], np.asarray(node["b"]))
        assert got["xs"] == float(node["xs"]) and got.get("os") == (
            float(node["os"]) if "os" in node else None), path
    assert counts["int8"] >= 40 and counts["float"] >= 5 and counts["as"] >= 2, counts


def _count_groups(groups):
    parent = {}

    def find(i):
        while parent[i] != i:
            i = parent[i]
        return i

    for grp in groups:
        for s in grp:
            parent.setdefault(id(s), id(s))
        for s in grp[1:]:
            parent[find(id(s))] = find(id(grp[0]))
    sizes = {}
    for i in parent:
        sizes[find(i)] = sizes.get(find(i), 0) + 1
    return sorted(sizes.values())


def test_finalize_scales_matches_jax(calibrated):
    jm = calibrated[0]
    jq, tq = _quantized_pair(calibrated)
    x = np.random.default_rng(1).random((1, 64, 64, 3)).astype(np.float32)

    jgroups, tgroups = [], []
    JB._UNIFY = jgroups
    try:
        jm.head_outputs(jq, jnp.asarray(x))
    finally:
        JB._UNIFY = None
    TB._UNIFY = tgroups
    try:
        with torch.no_grad():
            tq.head_outputs(torch.from_numpy(x))
    finally:
        TB._UNIFY = None
    assert len(tgroups) == len(jgroups)
    sizes = _count_groups(tgroups)
    assert sizes == _count_groups(jgroups)
    assert max(sizes) >= 3  # the PAN concats merge through the backbone taps

    jf = unwrap_static(JQ.finalize_scales(jm.head_outputs, jq, x))
    TQ.finalize_scales(tq, x)
    n = 0
    for path, node, mod in walk_convs(jf, tq):
        for key, attr in (("xs", "xs"), ("os", "os"), ("as", "as_")):
            if key in node:
                v = getattr(mod, attr)
                assert type(v) is float and v == node[key], (path, key)
                n += 1
    assert n >= 80


# --- the slice at nano width --------------------------------------------

NANO = (0.33, 0.25)
SIZE = 128


@pytest.fixture(scope="module")
def nano_int8():
    """JAX: init -> calibrate -> quantize -> finalize at nano width, with the
    head biases raised so the serving config has candidates; the finalized
    tree carried into a port YOLO."""
    cfg = dict(score_thresh=0.25, pre_nms_topk=512)
    jm = JaxYOLO(*NANO, **cfg)
    params = shift_head_bias(randomize_convs(jm.init(jax.random.PRNGKey(11)), 11), 6.0)
    rng = np.random.default_rng(2)
    cal = [jnp.asarray(rng.random((2, 96, 128, 3)), jnp.float32) for _ in range(2)]
    pc = JQ.calibrate_activations(jm.head_outputs, params, cal)
    qp = JQ.finalize_scales(jm.head_outputs, JQ.quantize_compute_params(pc),
                            np.asarray(cal[0][:1]))
    tm = YOLO(*NANO, device="cpu", **cfg)
    params_from_jax(unwrap_static(qp), tm)
    return jm, qp, tm


def test_int8_slice_features_and_logits_match_jax(nano_int8):
    """int8 features must be identical.  Head logits: the head conv's
    epilogue rounds as the eager JAX path does, so they agree to float32
    rounding; 1e-5 relative to the largest logit covers a sigmoid ulp that
    flips one int8 activation level upstream (none does here)."""
    jm, qp, tm = nano_int8
    assert sum(isinstance(m, Bottleneck) and m.as_ is not None for m in tm.modules()) >= 1
    x = np.random.default_rng(3).random((2, 96, 128, 3)).astype(np.float32)
    jfeats = jm.features(qp, jnp.asarray(x))
    with torch.no_grad():
        tfeats = tm.features(torch.from_numpy(x))
    for jf, tf in zip(jfeats, tfeats):
        _same(jf, tf)
    want = jm.head(qp["head"], jfeats)
    with torch.no_grad():
        got = tm.head(tfeats)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def _jax_detect(jm, qp, raw):
    b, h, w, _ = raw.shape
    plan = JT.make_plan([(h, w)], SIZE, SIZE, 32)[0]
    canvas = JT.letterbox_batch(jnp.asarray(raw), plan, 114 / 255.0)
    outs = jm.head_outputs(qp, canvas)
    det = JN.batched_postprocess_from_heads(
        outs, jm.strides, jm.anchor_grids, num_classes=jm.num_classes,
        score_thresh=jm.score_thresh, nms_thresh=jm.nms_thresh,
        detections_per_img=jm.detections_per_img, pre_nms_topk=jm.pre_nms_topk,
        flatten_pad="cell", topk_impl="bisect", row_gather="pallas_bisect", nms_impl="xla",
    )
    boxes = JT.scale_coords_back(det.boxes, plan.canvas_hw, jnp.asarray([h, w], jnp.float32))
    return [{"boxes": np.asarray(boxes[i][:n]), "labels": np.asarray(det.labels[i][:n])}
            for i, n in enumerate(np.asarray(det.num))]


def test_int8_serving_detections_match_jax(nano_int8):
    """``YOLOv5.__call__`` on the quantized port model against the JAX
    pipeline on the finalized tree, matched by label with boxes within 1e-3
    px (the tolerance of tests/test_torch_slice.py)."""
    jm, qp, tm = nano_int8
    model = YOLOv5(model=tm, device="cpu", size=(SIZE, SIZE))
    rng = np.random.default_rng(4)
    images = [rng.random((100, 130, 3)).astype(np.float32) for _ in range(2)]
    got = model(images)
    want = _jax_detect(jm, qp, np.stack(images))
    for g, w in zip(got, want):
        assert len(w["boxes"]) > 0 and len(g["boxes"]) == len(w["boxes"])
        for box, label in zip(w["boxes"], w["labels"]):
            close = (g["labels"] == label) & (np.abs(g["boxes"] - box).max(-1) <= 1e-3)
            assert close.any(), (box, label)
