"""The yaml model DSL of the port against the JAX package, on the CPU.

- The parse tests of tests/test_yaml_model.py: the yolov5n yaml against
  the registry's model (strides, anchors, feature shapes), the P6 layout,
  the depth and width gains, the save list, an unsupported module.
- yolov5n from ``build_yaml_config("n")`` at nano width: JAX's ``init``
  params (random BatchNorm statistics, every other conv folded) carried
  across, head outputs within atol 1e-4 (tests/test_torch_families.py).
- The fabricated non-standard checkpoint of ``torch_fixture`` (an extra
  C3 at flat index 14, which the fixed index maps cannot express),
  loaded by both packages' ``load_yaml_from_ultralytics``: every leaf
  bit-equal, the port's decode within the JAX test's tolerance of the
  torch oracle, and the Detections of the JAX model's head outputs equal
  to the JAX cell path's on them (``topk_impl='bisect'``): count, labels
  and order exactly, scores and boxes within rtol 1e-6.
- The ``Detector`` surface on a yaml model: ``with_thresholds`` and
  ``YOLOv5(model=...)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_fixture import make_custom_checkpoint
from torch_parity import randomize_convs
from yolort_tpu.models import yaml_model as JY
from yolort_tpu.ops import nms as JN
from yolort_tpu_torch.models import YOLOv5
from yolort_tpu_torch.models import yaml_model as TY
from yolort_tpu_torch.models._bridge import params_from_jax, params_to_jax
from yolort_tpu_torch.models._checkpoint import _flatten
from yolort_tpu_torch.models.yolo import build_yolo


def test_parse_standard_matches_registry():
    m = TY.YAMLDetectionModel(TY.build_yaml_config("n", num_classes=7), device="cpu")
    ref = build_yolo("yolov5_darknet_pan_n_r60", num_classes=7, device="cpu")
    assert m.strides == ref.strides and m.anchor_grids == ref.anchor_grids
    x = torch.zeros(1, 96, 128, 3)
    with torch.no_grad():
        assert ([o.shape for o in m.head_outputs(x)] == [o.shape for o in ref.head_outputs(x)])
    # the same parameter count, layer by layer renamed
    assert sum(p.numel() for p in m.parameters()) == sum(p.numel() for p in ref.parameters())


def test_parse_p6_layout():
    m = TY.YAMLDetectionModel(TY.build_yaml_config("s", p6=True, num_classes=3), device="cpu")
    assert m.strides == (8, 16, 32, 64) and len(m.anchor_grids) == 4
    with torch.no_grad():
        outs = m.head_outputs(torch.zeros(1, 128, 128, 3))
    assert [o.shape[1] for o in outs] == [16, 8, 4, 2]


def test_parse_depth_width_gains_and_save_list():
    cfg = TY.build_yaml_config("m", num_classes=80)  # gd 0.67, gw 0.75
    layers, save, meta = TY.parse_model(cfg)
    jlayers, jsave, jmeta = JY.parse_model(cfg)
    c3 = layers[2].block
    assert len(c3.m) == 2  # round(3 * 0.67)
    assert c3.cv3.weight.shape[0] == 96  # make_divisible(128 * 0.75, 8)
    assert meta["strides"] == (8, 16, 32)
    assert {4, 6, 10, 14, 17, 20, 23} <= set(save)
    assert save == jsave
    assert [(s.i, s.f, s.kind, s.name, s.extra) for s in layers] == [
        (s.i, s.f, s.kind, s.name, s.extra) for s in jlayers]
    assert {k: v for k, v in meta.items()} == jmeta


def test_unsupported_module_raises():
    cfg = TY.build_yaml_config("n")
    cfg["backbone"][0][2] = "TotallyUnknownBlock"
    with pytest.raises(ValueError, match="Unsupported yaml module"):
        TY.parse_model(cfg)


def test_yolov5n_yaml_matches_jax():
    cfg = TY.build_yaml_config("n", num_classes=7)
    jm = JY.YAMLDetectionModel(cfg)
    params = randomize_convs(jm.init(jax.random.PRNGKey(3)), 3)
    tm = params_from_jax(params, TY.YAMLDetectionModel(cfg, device="cpu"))
    x = np.random.default_rng(1).random((2, 96, 128, 3)).astype(np.float32)
    want = jax.jit(jm.head_outputs)(params, jnp.asarray(x))
    with torch.no_grad():
        got = tm.head_outputs(torch.from_numpy(x))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=0)


@pytest.fixture(scope="module")
def custom(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "custom.pt")
    oracle = make_custom_checkpoint(path, nc=7, seed=5)
    jm, jparams = JY.load_yaml_from_ultralytics(path)
    tm = TY.load_yaml_from_ultralytics(path, device="cpu", score_thresh=0.05, pre_nms_topk=512)
    return path, oracle, jm, jparams, tm


def test_custom_checkpoint_leaves_are_jax_bit_for_bit(custom):
    _, _, jm, jparams, tm = custom
    assert tm.num_classes == 7 and tm.strides == jm.strides == (8, 16, 32)
    assert tm.anchor_grids == jm.anchor_grids
    want, got = _flatten(jax.tree_util.tree_map(np.asarray, jparams)), _flatten(params_to_jax(tm))
    assert sorted(got) == sorted(want) and "14/cv3/w" in got
    for key, w in want.items():
        np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_custom_checkpoint_decode_matches_the_torch_oracle(custom):
    """Within the JAX test's tolerance (tests/test_yaml_model.py: the oracle
    holds the fp16 weights unfolded, the loaders fold them)."""
    _, oracle, _, _, tm = custom
    x = np.random.default_rng(0).uniform(0, 1, (1, 3, 64, 96)).astype(np.float32)
    with torch.no_grad():
        ref = oracle(torch.from_numpy(x)).numpy()  # (1, total, no), anchor-major a level
        img = torch.from_numpy(x.transpose(0, 2, 3, 1))
        outs = tm.head_outputs(img)
        pred = tm.decode(img).numpy()
    na, no = 3, 12
    ref_hwa, off = [], 0
    for o in outs:
        h, w = o.shape[1:3]
        ref_hwa.append(ref[:, off:off + na * h * w].reshape(1, na, h, w, no)
                       .transpose(0, 2, 3, 1, 4).reshape(1, -1, no))
        off += na * h * w
    ref_hwa = np.concatenate(ref_hwa, axis=1)
    assert pred.shape == ref_hwa.shape
    np.testing.assert_allclose(pred, ref_hwa, rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(pred[..., 4:], ref_hwa[..., 4:], atol=2e-3)


def test_custom_checkpoint_detections_match_jax(custom):
    """On one set of logits (a fabricated network scores nearly every pair
    alike, tests/test_torch_checkpoint.py): the JAX model's head outputs."""
    _, _, jm, jparams, tm = custom
    x = np.random.default_rng(1).uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    heads = [np.array(h) for h in jax.jit(jm.head_outputs)(jparams, jnp.asarray(x))]
    want = jax.jit(lambda hs: JN.batched_postprocess_from_heads(
        hs, jm.strides, jm.anchor_grids, num_classes=7, score_thresh=tm.score_thresh,
        nms_thresh=tm.nms_thresh, detections_per_img=tm.detections_per_img,
        pre_nms_topk=tm.pre_nms_topk, flatten_pad="cell", topk_impl="bisect",
        row_gather="pallas_bisect", nms_impl="xla",
    ))([jnp.asarray(h) for h in heads])
    with torch.no_grad():
        got = tm.postprocess([torch.from_numpy(h) for h in heads])
    assert (got.num.numpy() > 0).all()
    np.testing.assert_array_equal(got.num.numpy(), np.asarray(want.num))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-6, atol=1e-5)


def test_yaml_model_serves_through_yolov5_and_with_thresholds(custom):
    _, _, _, _, tm = custom
    loose = tm.with_thresholds(score_thresh=0.0, detections_per_img=50)
    assert loose.score_thresh == 0.0 and tm.score_thresh == 0.05
    assert loose.head is tm.head and loose.detections_per_img == 50
    frames = list(np.random.default_rng(2).integers(0, 256, (2, 70, 90, 3), dtype=np.uint8))
    out = YOLOv5(model=loose, size=(96, 96))(frames)
    assert [len(d["scores"]) for d in out] == [50, 50]
    for d in out:
        assert (d["labels"] < 7).all() and (d["boxes"][:, 2:] <= [90, 70]).all()
