"""The port's network against the JAX network on the same weights, f32 on
the CPU, and the param bridge.

head_outputs tolerance atol 1e-4: about sixty convolutions deep, the two
frameworks' summation orders drift apart by ~1e-5 per layer."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolort_tpu_torch
from torch_parity import DEPTH, WIDTH, tiny_pair
from yolort_tpu.models import darknet as jdarknet
from yolort_tpu_torch.models import darknet as tdarknet
from yolort_tpu_torch.models.head import DEFAULT_ANCHOR_GRIDS, DEFAULT_STRIDES, anchor_props_from_index
from yolort_tpu_torch.ops.blocks import Conv, Conv2dOnly


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=0)


def test_head_outputs_match_jax(pair):
    jm, params, tm = pair
    x = np.random.default_rng(0).random((2, 128, 160, 3)).astype(np.float32)
    want = jm.head_outputs(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm.head_outputs(torch.from_numpy(x))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape  # NHWC (B, H, W, A*85)
        assert g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


def test_bridge_round_trip(pair):
    """Every JAX leaf lands in the port: HWIO -> OIHW weights, fused biases
    or unfused BatchNorm buffers, nothing left over."""
    _, params, tm = pair
    seen = {"fused": 0, "unfused": 0}

    def walk(p, module):
        if isinstance(module, (Conv, Conv2dOnly)):
            np.testing.assert_array_equal(module.weight.detach().numpy().transpose(2, 3, 1, 0), p["w"])
            if "b" in p:
                seen["fused"] += 1
                np.testing.assert_array_equal(module.bias.detach().numpy(), p["b"])
            else:
                seen["unfused"] += 1
                assert module.bias is None
                for name in ("gamma", "beta", "mean", "var"):
                    np.testing.assert_array_equal(getattr(module, name).numpy(), p[name])
            return
        assert set(p) == set(module._modules), (type(module).__name__, sorted(p))
        for key, sub in p.items():
            walk(sub, module._modules[key])

    walk(params, tm)
    assert seen["fused"] > 0 and seen["unfused"] > 0


def test_bridge_rejects_unknown_key(pair):
    from yolort_tpu_torch.models._bridge import params_from_jax

    _, _, tm = pair
    with pytest.raises(KeyError):
        params_from_jax({"neck": {}}, tm)


@pytest.mark.parametrize("v,d", [(64 * 0.125, 8), (1024 * 0.33, 8), (3.2, 8), (100, 16)])
def test_make_divisible_and_depth_gain(v, d):
    assert tdarknet.make_divisible(v, d) == jdarknet.make_divisible(v, d)
    assert tdarknet.depth_gain(9, DEPTH) == jdarknet.depth_gain(9, DEPTH)


def test_backbone_channels_and_prior_bias(pair):
    jm, _, tm = pair
    with torch.no_grad():
        feats = tm.backbone(torch.zeros(1, 3, 64, 64).contiguous(memory_format=torch.channels_last))
    assert tuple(f.shape[1] for f in feats) == jm.backbone.out_channels
    fresh = yolort_tpu_torch.YOLO(DEPTH, WIDTH, device="cpu")
    b = fresh.head._modules["0"].bias.view(3, 85)
    # prior-probability init: obj near log(8/80^2), classes near log(0.6/79)
    assert float(b[:, 4].mean()) < -5 and float(b[:, 5:].mean()) < -4


def test_anchor_props_match_tables():
    from yolort_tpu.models.head import anchor_tables

    grids = ((4, 5), (2, 3), (1, 2))
    g, s, st = (np.asarray(a) for a in anchor_tables(grids, DEFAULT_STRIDES, DEFAULT_ANCHOR_GRIDS))
    idx = torch.arange(g.shape[0])
    tg, ts, tst = anchor_props_from_index(idx, grids, DEFAULT_STRIDES, DEFAULT_ANCHOR_GRIDS)
    np.testing.assert_array_equal(tg.numpy(), g)
    np.testing.assert_array_equal(ts.numpy(), s)
    np.testing.assert_array_equal(tst.numpy(), st)


def test_factories_and_registry():
    from yolort_tpu.models.yolo import ARCHS as JARCHS
    from yolort_tpu_torch.models.yolo import ARCHS, build_yolo

    assert set(ARCHS) == set(JARCHS)
    m = yolort_tpu_torch.yolov5n(device="cpu", seed=1)
    assert m.model.num_classes == 80 and m.dtype == torch.float32
    with pytest.raises(ValueError):
        build_yolo("yolov5_darknet_pan_n_r31", device="cpu")
    with pytest.raises(ValueError):
        yolort_tpu_torch.yolov5n(device="cpu", dtype=torch.float16)


def test_models_default_to_the_card_and_never_fall_back():
    """Without ``device`` a model is built on the card; where torch sees no
    CUDA device that raises, and nothing runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device would build")
    from yolort_tpu_torch.models.yolo import build_yolo

    for build in (yolort_tpu_torch.yolov5n, lambda: build_yolo("yolov5_darknet_pan_n_r60"),
                  lambda: yolort_tpu_torch.YOLO(DEPTH, WIDTH)):
        with pytest.raises(RuntimeError, match="CUDA device"):
            build()


def test_a_model_passed_in_is_served_where_it_lies():
    model = yolort_tpu_torch.YOLO(DEPTH, WIDTH, device="cpu")
    assert yolort_tpu_torch.YOLOv5(model=model).device == torch.device("cpu")
    assert yolort_tpu_torch.YOLOv5(model=model, device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="differs from the model"):
        yolort_tpu_torch.YOLOv5(model=model, device="meta")
    # a model that keeps its tensors as buffers only, as a quantized one does
    frozen = torch.nn.Module()
    frozen.register_buffer("w", torch.zeros(1))
    frozen.num_classes = 80
    assert yolort_tpu_torch.YOLOv5(model=frozen).device == torch.device("cpu")
