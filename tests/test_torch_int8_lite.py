"""yolo_lite (5 classes) in int8 against the JAX package, float32 on the
CPU; the helpers and yolov5n's cases are tests/test_torch_int8_recipe.py.

- Calibrated at 64x64: ``quant_groups`` equal to JAX's ('backbone/body',
  'backbone/fpn', 'head/0'..'head/3'); under the defaults (41 convs, none
  grouped or ReLU), ``skip`` of the FPN group, a 1x1-only ``predicate``,
  ``chain=False`` and ``min_reduce=1`` (61 convs: the depth-wise ones on
  ``qconv_grouped``, the ReLU expand convs) the same quantized paths with
  every leaf bit-equal.
- The forward under the default recipe and under ``min_reduce=1``,
  unfinalized (runtime scales) and finalized: the body's int8 taps
  bit-equal, head outputs within 1e-5 of the largest.  JAX's
  SqueezeExcite has no int8 input (``jnp.mean`` of a QTensor raises),
  where the port's dequantizes first: under ``min_reduce=1`` the
  depth-wise convs hand SE a QTensor, so the JAX block is given the
  dequantized input there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_int8_recipe import (
    OPTIONS, SIZE, _calibrated, check_quant_groups, check_recipe_leaves, recipe_options, same_q,
)
from yolort_tpu.ops import blocks as JB
from yolort_tpu.ops import quantization as JQ
from yolort_tpu_torch.ops import quantization as TQ


@pytest.fixture(scope="module")
def lite():
    return _calibrated("yolo_lite")


def test_quant_groups_match_jax(lite):
    assert check_quant_groups(lite) == (
        "backbone/body", "backbone/fpn", "head/0", "head/1", "head/2", "head/3")


@pytest.mark.parametrize("option", OPTIONS)
def test_recipe_leaves_match_jax(lite, option):
    paths = check_recipe_leaves(lite, recipe_options(option, "backbone/fpn"))
    convs = dict(TQ.conv_paths(lite[2]))
    grouped = [p for p in paths if convs[p].g > 1]
    relu = [p for p in paths if getattr(convs[p], "act", "") == "relu"]
    if option == "min_reduce_1":
        assert (len(paths), len(grouped), len(relu)) == (61, 11, 5)
    if option == "defaults":
        assert (len(paths), len(grouped), len(relu)) == (41, 0, 0)


@pytest.fixture
def se_takes_float(monkeypatch):
    """JAX's SqueezeExcite given its input dequantized, as the port's takes it."""
    call = JB.SqueezeExcite.__call__
    monkeypatch.setattr(JB.SqueezeExcite, "__call__",
                        lambda self, p, x: call(self, p, JB._as_float(x)))


@pytest.mark.parametrize("finalized", [False, True])
@pytest.mark.parametrize("min_reduce", [32, 1])
def test_yolo_lite_int8_matches_jax(lite, se_takes_float, min_reduce, finalized):
    jm, pc, tm, x = lite
    jq = JQ.quantize_compute_params(pc, min_reduce=min_reduce)
    tq = TQ.quantize_compute_params(tm, min_reduce=min_reduce)
    if finalized:
        jq = JQ.finalize_scales(jm.head_outputs, jq, x[:1])
        TQ.finalize_scales(tq, x[:1])
        assert all(type(m.xs) is float for _, m in TQ.conv_paths(tq) if m.quantized)
    xin = np.random.default_rng(5).random((2, SIZE, SIZE, 3)).astype(np.float32)

    def jax_forward(p, x):
        body = jm.backbone.body(p["backbone"]["body"], x)
        return body, jm.head(p["head"], jm.backbone.fpn(p["backbone"]["fpn"], body))

    # jitted: eager JAX compiles every op anew for each tree's scale values
    jbody, want = jax.jit(jax_forward)(jq, jnp.asarray(xin))
    with torch.no_grad():
        body = tq.backbone.body(tq.nchw(torch.from_numpy(xin)))
        got = tq.head(tq.backbone.fpn(body))
    # the body's int8 taps (the FPN's Conv2dOnly outputs are float)
    for jf, tf in zip(jbody, body):
        same_q(tf, jf)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
