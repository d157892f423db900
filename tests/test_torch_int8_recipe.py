"""The rest of the int8 recipe against the JAX package, float32 on the CPU.

- ``qconv_grouped_reference`` bit-equal to an int64 numpy grouped conv
  plus the epilogue, at G outside {1, C} (C/G = 1, 3, 4, 8), depth-wise,
  k 3 and 5, strides 1 and 2: each output channel reads its own group.
  The ``relu`` epilogue bit-equal to JAX's ``_ACTS["relu"]``.
- The recipe on yolov5n r6.0, calibrated at 64x64 (yolo_lite's in
  tests/test_torch_int8_lite.py): ``quant_groups`` equal to JAX's, and
  under the defaults, ``skip`` of the worst group of JAX's scan, a
  1x1-only ``predicate``, ``chain=False`` and ``min_reduce=1`` the same
  quantized paths with ``wq``, ``ws``, ``xs``, ``os``, ``as`` bit-equal.
- The forward unfinalized: yolov5n's PAN features bit-equal to JAX's
  eager and jitted forward (the runtime branches: the tree
  ``int8_ap_report`` runs).
- ``sensitivity_scan`` on yolov5n with ``decode``: JAX's group order, the
  deltas within 1e-5 relative.
- Weight-only PTQ: ``quantize_params`` equal to JAX's, ``quantization_error``
  within 1e-6; the dequantized model's detections beside the float
  model's and ``CalibrationObserver`` (the JAX package's own tests of
  them, on the port).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_families import _numpy_init
from test_torch_yolo_lite import numpy_init as lite_numpy_init
from torch_parity import (
    copy_marks, nhwc_to_port, port_int8_leaf, port_to_nhwc, randomize_convs, unwrap_static,
    walk_convs, walk_convs_paths,
)
from yolort_tpu.models.yolo import YOLO as JaxYOLO
from yolort_tpu.models.yolo_lite import yolov5_mobilenet_v3_small_fpn as jax_lite
from yolort_tpu.ops import blocks as JB
from yolort_tpu.ops import quantization as JQ
from yolort_tpu_torch import yolov5_mobilenet_v3_small_fpn
from yolort_tpu_torch.models._bridge import params_from_jax, params_to_jax
from yolort_tpu_torch.models.yolo import YOLO, build_yolo
from yolort_tpu_torch.ops import blocks as TB
from yolort_tpu_torch.ops import quantization as TQ
from yolort_tpu_torch.ops.blocks import Bottleneck
from yolort_tpu_torch.ops.cuda.qconv_kernel import (
    _epilogue, pack_weight, qconv, qconv_grouped_reference,
)

NANO = (0.33, 0.25)
SIZE = 64


# --- the kernels' plain versions ------------------------------------------

def _grouped_int64(xq, w_hwio, stride, pad, groups):
    """(N, Ho, Wo, Cout) int64 grouped conv of NHWC int8 values."""
    n, h, w, c = xq.shape
    k, _, cg, cout = w_hwio.shape
    og = cout // groups
    x = np.pad(xq.astype(np.int64), ((0, 0), (pad, pad), (pad, pad), (0, 0)))
    ho, wo = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    wg = w_hwio.astype(np.int64).reshape(k, k, cg, groups, og)
    acc = np.zeros((n, ho, wo, groups, og), np.int64)
    for ky in range(k):
        for kx in range(k):
            patch = x[:, ky:ky + stride * ho:stride, kx:kx + stride * wo:stride]
            acc += np.einsum("nhwgc,cgo->nhwgo", patch.reshape(n, ho, wo, groups, cg),
                             wg[ky, kx])
    return acc.reshape(n, ho, wo, cout)


# (C, Cout, groups, k, stride): C/G 1 (Cout/G 2), 3 (DWConv(96, 64, 5)), 4, 8
# and depth-wise, 3x3 and 5x5, strides 1 and 2
GROUPED = [
    (8, 16, 8, 3, 1), (8, 16, 8, 5, 2),
    (96, 64, 32, 5, 1), (12, 8, 4, 3, 2),
    (16, 8, 4, 3, 1), (16, 24, 4, 5, 2),
    (32, 16, 4, 3, 2), (32, 64, 4, 5, 1),
    (24, 24, 24, 3, 1), (24, 24, 24, 5, 2), (20, 20, 20, 3, 2),
]


@pytest.mark.parametrize("c,cout,groups,k,stride", GROUPED)
def test_qconv_grouped_reference_is_the_int64_grouped_conv(c, cout, groups, k, stride):
    rng = np.random.default_rng(c * 7 + groups + k)
    xq = rng.integers(-127, 128, (2, 9, 11, c), dtype=np.int8)
    w = rng.integers(-127, 128, (k, k, c // groups, cout), dtype=np.int8)
    scale = rng.uniform(1e-5, 1e-4, cout).astype(np.float32)
    bias = rng.uniform(-2, 2, cout).astype(np.float32)
    acc = _grouped_int64(xq, w, stride, k // 2, groups)
    x_t = nhwc_to_port(xq).contiguous(memory_format=torch.channels_last)
    args = (x_t, pack_weight(w), torch.from_numpy(scale), torch.from_numpy(bias))
    acc_t = torch.from_numpy(acc.transpose(0, 3, 1, 2).astype(np.int32))
    for act in ("relu", "hardswish", "none"):
        for inv, dt in ((30.0, torch.float32), (None, torch.float32), (None, torch.bfloat16)):
            got = qconv(*args, k=k, stride=stride, groups=groups, act=act, inv_out_scale=inv,
                        out_dtype=dt)
            assert got.is_contiguous(memory_format=torch.channels_last)
            want = _epilogue(acc_t, args[2], args[3], act, inv, dt)
            assert got.dtype == want.dtype and torch.equal(got, want), (act, inv, dt)
    # each output channel reads its own group: a group's input moved
    # moves only that group's outputs
    x2 = xq.copy()
    x2[..., : c // groups] = 0
    moved = _grouped_int64(x2, w, stride, k // 2, groups) != acc
    assert not moved[..., cout // groups:].any() and moved[..., : cout // groups].any()
    got = qconv_grouped_reference(*args, k=k, stride=stride, groups=groups, act="none")
    assert torch.equal(got, _epilogue(acc_t, args[2], args[3], "none", None, torch.float32))


def test_relu_epilogue_is_jax_relu():
    rng = np.random.default_rng(9)
    acc = rng.integers(-40000, 40001, (2, 16, 5, 6)).astype(np.int32)
    acc[0, :, 0, 0] = 0
    scale = rng.uniform(1e-4, 3e-4, 16).astype(np.float32)
    bias = rng.uniform(-3, 3, 16).astype(np.float32)
    y = jnp.asarray(acc.astype(np.float32)) * jnp.asarray(scale)[:, None, None]
    y = y + jnp.asarray(bias)[:, None, None]
    want = np.asarray(JB._ACTS["relu"](y))
    got = _epilogue(torch.from_numpy(acc), torch.from_numpy(scale), torch.from_numpy(bias),
                    "relu", None, torch.float32)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 0).any() and (want > 0).any()
    q = np.asarray(JB._requantize(JB._ACTS["relu"](y), JB.StaticScale(0.05)).q)
    got = _epilogue(torch.from_numpy(acc), torch.from_numpy(scale), torch.from_numpy(bias),
                    "relu", 1.0 / 0.05, torch.float32)
    np.testing.assert_array_equal(got.numpy(), q)
    with pytest.raises(ValueError, match="act"):
        qconv(torch.zeros(1, 4, 3, 3, dtype=torch.int8), torch.zeros(8, 36, dtype=torch.int8),
              torch.ones(8), torch.zeros(8), k=3, groups=1, act="gelu")


# --- the recipe --------------------------------------------------------------

def _calibrated(name):
    """(JAX model, its calibrated numpy tree, the port model with the same
    weights and marks, the batch) at 64x64."""
    x = np.random.default_rng(1).random((2, SIZE, SIZE, 3)).astype(np.float32)
    if name == "yolov5n":
        jm = JaxYOLO(*NANO)
        params = randomize_convs(_numpy_init(jm, 3), 3)
        tm = YOLO(*NANO, device="cpu")
    else:
        jm = jax_lite(num_classes=5)
        params = randomize_convs(lite_numpy_init(jm, 0), 0)
        tm = yolov5_mobilenet_v3_small_fpn(num_classes=5, device="cpu")
    params_from_jax(params, tm)
    pc = JQ.calibrate_activations(jm.head_outputs, params, [jnp.asarray(x)])
    copy_marks(pc, tm)
    return jm, pc, tm, x


@pytest.fixture(scope="module")
def nano():
    return _calibrated("yolov5n")


@pytest.fixture(scope="module")
def nano_scan(nano):
    """JAX's sensitivity scan of the calibrated yolov5n on decode (eager,
    the runtime-scale branches)."""
    jm, pc, _, x = nano
    return JQ.sensitivity_scan(lambda p, b: jm.decode(p, b), pc, jnp.asarray(x))


def check_quant_groups(calibrated):
    _, pc, tm, _ = calibrated
    want = JQ.quant_groups(pc)
    assert TQ.quant_groups(tm) == want
    assert TQ.quant_groups(tm, depth=3) == JQ.quant_groups(pc, depth=3)
    return want


def test_quant_groups_match_jax(nano):
    assert "pan/layer" in check_quant_groups(nano)


OPTIONS = ["defaults", "skip", "predicate", "no_chain", "min_reduce_1"]


def recipe_options(option, worst):
    return {"defaults": {}, "skip": dict(skip=(worst, "backbone/body/1")),
            "predicate": dict(predicate=lambda p, s: s[0] == 1 and s[1] == 1),
            "no_chain": dict(chain=False), "min_reduce_1": dict(min_reduce=1)}[option]


def check_recipe_leaves(calibrated, kw) -> list:
    """JAX's and the port's quantize_compute_params(**kw) on the same marks:
    the same quantized paths, and every leaf bit-equal: packed ``wq``,
    ``ws``, the bias, ``xs`` / ``os`` / ``as`` as runtime scales of JAX's
    float32 values (absent under ``chain=False``).  Returns the paths."""
    _, pc, tm, _ = calibrated
    jq = JQ.quantize_compute_params(pc, **kw)
    tq = TQ.quantize_compute_params(tm, **kw)
    assert not any(hasattr(m, k) for m in tq.modules() for k in ("_absmax", "_out_absmax"))
    assert hasattr(next(m for _, m in TQ.conv_paths(tm)), "_absmax")  # the model kept its marks
    paths = [p for p, m in TQ.conv_paths(tq) if m.quantized]
    assert paths == [p for p, node, _ in walk_convs_paths(jq) if "wq" in node]
    assert 0 < len(paths) <= sum(1 for _ in TQ.conv_paths(tq))
    chain = kw.get("chain", True)
    n_as = 0
    for path, node, mod in walk_convs(jq, tq):
        if isinstance(mod, Bottleneck):
            assert (mod.as_ is None) == ("as" not in node)
            if "as" in node:
                assert isinstance(mod.as_, TB.ScaleLeaf) and mod.as_ == float(node["as"])
                n_as += 1
            continue
        if not mod.quantized:
            continue
        got = port_int8_leaf(mod)
        np.testing.assert_array_equal(got["wq"], pack_weight(np.asarray(node["wq"])).numpy())
        np.testing.assert_array_equal(got["ws"], np.asarray(node["ws"]))
        np.testing.assert_array_equal(got["b"], np.asarray(node.get("b", np.zeros_like(got["b"]))))
        assert isinstance(mod.xs, TB.ScaleLeaf) and got["xs"] == float(node["xs"]), path
        assert got.get("os") == (float(node["os"]) if "os" in node else None), path
        assert chain or "os" not in got
    assert chain or not n_as
    for prefix in kw.get("skip", ()):
        assert not any(p.startswith(prefix) for p in paths)
    return paths


@pytest.mark.parametrize("option", OPTIONS)
def test_recipe_leaves_match_jax(nano, nano_scan, option):
    """yolov5n under each option; ``skip`` takes the worst group of JAX's
    scan."""
    paths = check_recipe_leaves(nano, recipe_options(option, nano_scan[0][0]))
    n_all = sum(1 for _ in TQ.conv_paths(nano[2]))
    assert len(paths) == n_all if option == "min_reduce_1" else len(paths) < n_all
    n_as = sum(m.as_ is not None for m in TQ.quantize_compute_params(
        nano[2], **recipe_options(option, nano_scan[0][0])).modules() if isinstance(m, Bottleneck))
    assert (n_as > 0) == (option != "no_chain")


# --- the forward ---------------------------------------------------------------

def same_q(got, want):
    assert isinstance(got, TB.QTensor) and got.s == float(JB._sv(want.s))
    np.testing.assert_array_equal(port_to_nhwc(got.q), np.asarray(want.q))


def test_yolov5n_unfinalized_pan_features_match_jax(nano):
    """The runtime branches (``_qconcat``, ``_qadd``, the requantize on
    float32 scales): PAN features bit-equal to JAX's eager and jitted
    forward of the unfinalized tree."""
    jm, pc, tm, _ = nano
    jq = JQ.quantize_compute_params(pc)
    tq = TQ.quantize_compute_params(tm)
    xin = np.random.default_rng(6).random((2, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        tfeats = tq.features(torch.from_numpy(xin))
    assert all(isinstance(f.s, TB.ScaleLeaf) for f in tfeats)
    for jf, tf in zip(jm.features(jq, jnp.asarray(xin)), tfeats):
        same_q(tf, jf)
    jitted = jax.jit(jm.features)(jq, jnp.asarray(xin))
    for jf, tf in zip(jitted, tfeats):
        np.testing.assert_array_equal(port_to_nhwc(tf.q), np.asarray(jf.q))


def test_sensitivity_scan_matches_jax(nano, nano_scan):
    _, _, tm, x = nano
    got = TQ.sensitivity_scan(lambda m, b: m.decode(b), tm, torch.from_numpy(x))
    assert [g for g, _ in got] == [g for g, _ in nano_scan]
    # tolerance: the float paths of the two frameworks differ by summation
    # order (~1e-7 of an output), which moves a group's delta by up to
    # ~1e-8 (JAX's own jitted and eager scans differ by that much); above
    # 1e-2 of the largest delta each agrees within 1e-3 relative, below it
    # within 1e-4 of the largest
    d_got, d_want = np.asarray([d for _, d in got]), np.asarray([d for _, d in nano_scan])
    big = d_want >= 1e-2 * d_want.max()
    assert big.sum() >= 5
    np.testing.assert_allclose(d_got[big], d_want[big], rtol=1e-3)
    np.testing.assert_allclose(d_got[~big], d_want[~big], rtol=0, atol=1e-4 * d_want.max())
    assert hasattr(next(m for _, m in TQ.conv_paths(tm)), "_absmax")  # the model untouched


# --- weight-only PTQ -------------------------------------------------------------

def test_quantize_params_and_error_match_jax(nano):
    _, pc, _, _ = nano
    params = unwrap_static(JQ.strip_calibration(pc))
    jq = JQ.quantize_params(params)
    tq = TQ.quantize_params(params)
    n = 0
    for path, node, _ in walk_convs_paths(jq):
        w = node["w"]
        if isinstance(w, dict):
            np.testing.assert_array_equal(tq_leaf(tq, path)["q"].numpy(), np.asarray(w["q"]))
            np.testing.assert_array_equal(tq_leaf(tq, path)["scale"].numpy(), np.asarray(w["scale"]))
            n += 1
        else:
            assert not isinstance(tq_leaf(tq, path), dict)
    assert n >= 30
    want = JQ.quantization_error(params, jq)
    got = TQ.quantization_error(params, tq)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-6, k


def tq_leaf(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree["w"]


def test_quantized_model_detection_parity():
    """tests/test_quantization.py's check on the port: the weight-only
    dequantized yolov5n detects as the float one does."""
    model = build_yolo("yolov5_darknet_pan_n_r60", num_classes=4, device="cpu",
                       pre_nms_topk=128, score_thresh=1e-5)
    model.init_train(0)
    qmodel = params_from_jax(
        TQ.dequantize_params(TQ.quantize_params(params_to_jax(model)), torch.float32),
        copy.deepcopy(model))
    head = dict(model.named_modules())["head.0"].weight
    assert not torch.equal(dict(qmodel.named_modules())["head.0"].weight, head)
    x = torch.from_numpy(np.random.default_rng(1).random((1, 96, 96, 3)).astype(np.float32))
    with torch.no_grad():
        d_fp, d_q = model(x), qmodel(x)
    n, nq = int(d_fp.num[0]), int(d_q.num[0])
    assert n > 0 and abs(n - nq) <= max(2, int(0.05 * n))
    m = min(n, nq, 50)
    np.testing.assert_allclose(d_fp.boxes[0][:m].numpy(), d_q.boxes[0][:m].numpy(), atol=3.0)
    bf = TQ.dequantize_params(TQ.quantize_params(params_to_jax(model)))
    assert bf["head"]["0"]["w"].dtype == torch.bfloat16


def test_calibration_observer():
    obs = TQ.CalibrationObserver(momentum=0.5)
    obs.observe("act0", torch.tensor([1.0, -2.0]))
    obs.observe("act0", torch.tensor([4.0]))
    assert obs.ranges["act0"] == pytest.approx(3.0)
    assert obs.scales()["act0"] == pytest.approx(3.0 / 127.0)
