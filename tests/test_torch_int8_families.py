"""int8 compute of the families beside r6.0 and P6 (r3.1, r4.0, TAN), and
the qconv epilogue's activations, against the JAX package on the CPU.

- The plain epilogue (``qconv_kernel._epilogue``) with each activation of
  the JAX kernel's ``_act`` (silu, hardswish, leaky_relu, none) against
  ``yolort_tpu.ops.pallas.qconv._epilogue``, float32 arithmetic: int8,
  float32 and bfloat16 out bit for bit, but SiLU's float32 out, within 2
  ulp on under 1% of the values (torch's and XLA's sigmoids; the kernel's
  SiLU has torch.sigmoid's bits).
- r3.1 (Hardswish everywhere: Focus's 12-channel conv, BottleneckCSP's
  raw convs, SPP's three pools over an int8 QTensor), r4.0 and TAN at nano
  width: the JAX recipe's finalized tree carried into the port gives
  identical int8 PAN features and head logits within 1e-5 of the largest
  logit (the bound of tests/test_torch_families.py for P6), and the
  port's own quantize and finalize on the JAX calibration marks give the
  same int8 leaves and every scale.

bfloat16 compute is not held against JAX: JAX's XLA int8 path applies the
activation and the requantize in the compute dtype, the port's kernel in
float32 before its cast.  chip_smoke.py holds the port's bf16 int8 serving
card against CPU with ``pair_detections``' tolerance (equal counts, >= 99%
paired, scores within 1e-5 relative, IoU > 0.999).
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_families import _pair
from torch_parity import copy_marks, port_int8_leaf, unwrap_static, walk_convs
from yolort_tpu.ops import quantization as JQ
from yolort_tpu.ops.pallas import qconv as JK
from yolort_tpu_torch.models._bridge import params_from_jax
from yolort_tpu_torch.models.yolo import YOLO
from yolort_tpu_torch.ops import quantization as TQ
from yolort_tpu_torch.ops.blocks import Bottleneck, Conv, Conv2dOnly
from yolort_tpu_torch.ops.cuda.qconv_kernel import ACTS, _epilogue, pack_weight, qconv

NANO = (0.33, 0.25)
ACT_NAMES = ("silu", "hardswish", "leaky_relu", "none")


def _epilogue_inputs(seed):
    """s32 accumulators, per-channel scale and bias whose y = acc * scale +
    bias spans [-12, 12]: both Hardswish knees (-3, +3), LeakyReLU's sign
    change, exact zeros and -0.0."""
    rng = np.random.default_rng(seed)
    acc = rng.integers(-30000, 30001, (2, 16, 6, 7)).astype(np.int32)
    acc[0, :, 0, 0] = 0
    scale = rng.uniform(1e-4, 4e-4, 16).astype(np.float32)
    bias = rng.uniform(-3.5, 3.5, 16).astype(np.float32)
    bias[3] = -0.0
    # exact knees: acc * scale + bias == -3, 0, +3 on channel 5
    scale[5], bias[5] = np.float32(2.0 ** -10), np.float32(0.0)
    acc[1, 5, 0, :3] = (-3 * 1024, 0, 3 * 1024)
    return acc, scale, bias


@pytest.mark.parametrize("act", ACT_NAMES)
@pytest.mark.parametrize("out", ["int8", "float32", "bfloat16"])
def test_plain_epilogue_matches_jax(act, out):
    acc, scale, bias = _epilogue_inputs(ACT_NAMES.index(act))
    inv = 40.0 if out == "int8" else None
    tdt = torch.float32 if out != "bfloat16" else torch.bfloat16
    got = _epilogue(torch.from_numpy(acc), torch.from_numpy(scale), torch.from_numpy(bias), act,
                    inv, tdt)
    # JAX's epilogue on NHWC rows, per-channel vectors broadcast on the last axis
    jdt = jnp.float32 if out != "bfloat16" else jnp.bfloat16
    want = JK._epilogue(jnp.asarray(acc.transpose(0, 2, 3, 1)), jnp.asarray(scale),
                        jnp.asarray(bias), jnp.float32(inv or 0.0), act, out == "int8", jdt)
    want = np.asarray(want.astype(jnp.float32) if out == "bfloat16" else want).transpose(0, 3, 1, 2)
    gotn = got.float().numpy() if out == "bfloat16" else got.numpy()
    assert gotn.dtype == want.dtype
    if out == "int8":
        np.testing.assert_array_equal(gotn, want)
    elif act == "silu" and out == "float32":
        # torch's and XLA's sigmoids differ by up to 2 ulp (module docstring
        # of tests/test_torch_qconv.py); every other activation is exact
        ulps = np.abs(gotn.view(np.int32).astype(np.int64) - want.view(np.int32))
        assert ulps.max() <= 2 and (ulps > 0).mean() < 0.01
    else:
        np.testing.assert_array_equal(gotn.view(np.int32), want.view(np.int32))
    if act in ("hardswish", "leaky_relu") and out == "float32":
        # channel 5's exact points: both activations give 3 at 3 and 0 at 0
        knees = gotn[1, 5, 0, :3]
        assert knees[2] == 3.0 and knees[1] == 0.0


def test_every_activation_has_a_kernel_code_and_unknown_ones_raise():
    # the JAX kernel's activations, and relu (the JAX blocks' XLA int8 path)
    assert sorted(ACTS) == sorted((*ACT_NAMES, "relu")) and sorted(ACTS.values()) == [0, 1, 2, 3, 4]
    xq = torch.zeros((1, 16, 4, 4), dtype=torch.int8).contiguous(memory_format=torch.channels_last)
    wq = pack_weight(np.zeros((1, 1, 16, 8), np.int8))
    scale, bias = torch.ones(8), torch.zeros(8)
    for act in ACTS:
        assert qconv(xq, wq, scale, bias, k=1, act=act).shape == (1, 8, 4, 4)
    with pytest.raises(ValueError, match="act"):
        qconv(xq, wq, scale, bias, k=1, act="relu6")


# --- r3.1, r4.0, TAN in int8 against the JAX recipe ------------------------

@pytest.fixture(scope="module", params=["r3.1", "r4.0", "tan"])
def int8_family(request):
    """A family's nano pair, its JAX tree calibrated on the first image,
    quantized and finalized (JAX eagerly, one image: each eager op
    compiles once a shape)."""
    jm, params, tm, x = _pair(request.param)
    x = x[:1]
    pc = JQ.calibrate_activations(jm.head_outputs, params, [jnp.asarray(x)])
    jfin = JQ.finalize_scales(jm.head_outputs, JQ.quantize_compute_params(pc), x)
    return request.param, jm, pc, jfin, unwrap_static(jfin), tm, x


def _kw(name):
    return dict(version="r4.0", use_tan=True) if name == "tan" else dict(version=name)


def test_int8_family_features_and_logits_match_jax(int8_family):
    name, jm, _, jfin, jf, _, x = int8_family
    tq = params_from_jax(jf, YOLO(*NANO, device="cpu", **_kw(name)))
    convs = [m for m in tq.modules() if isinstance(m, (Conv, Conv2dOnly))]
    quantized = [m for m in convs if m.quantized]
    assert len(quantized) >= 40
    if name == "r3.1":
        acts = {m.act for m in quantized if isinstance(m, Conv)}
        assert acts == {"hardswish"}
        # Focus's 12-channel conv and BottleneckCSP's raw convs run in int8
        assert tq.backbone._modules["0"].conv.quantized
        assert sum(isinstance(m, Conv2dOnly) and m.quantized and m.bias is None
                   for m in tq.backbone.modules()) >= 4
    jfeats = jm.features(jfin, jnp.asarray(x))
    with torch.no_grad():
        tfeats = tq.features(torch.from_numpy(x))
    assert len(tfeats) == 3
    for j, t in zip(jfeats, tfeats):
        assert t.q.dtype == torch.int8 and t.s == j.s.v
        np.testing.assert_array_equal(t.q.permute(0, 2, 3, 1).numpy(), np.asarray(j.q))
    with torch.no_grad():
        got = tq.head(tfeats)
    for g, w in zip(got, jm.head(jfin["head"], jfeats)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_int8_family_recipe_matches_jax(int8_family):
    """The port's quantize_compute_params and finalize_scales on the JAX
    calibration marks: the same int8 leaves and every scale of the
    finalized tree, concat groups included."""
    _, _, pc, _, jf, tm, x = int8_family
    port = copy.deepcopy(tm)
    copy_marks(pc, port)
    tq = TQ.finalize_scales(TQ.quantize_compute_params(port), x)
    n = 0
    for path, node, mod in walk_convs(jf, tq):
        if isinstance(mod, Bottleneck):
            assert (mod.as_ is None) == ("as" not in node)
            if mod.as_ is not None:
                assert mod.as_ == node["as"], path
            continue
        assert mod.quantized == ("wq" in node), path
        if not mod.quantized:
            continue
        got = port_int8_leaf(mod)
        np.testing.assert_array_equal(got["wq"], pack_weight(np.asarray(node["wq"])).numpy())
        np.testing.assert_array_equal(got["ws"], node["ws"])
        if "b" in node:
            np.testing.assert_array_equal(got["b"], node["b"])
        assert got["xs"] == node["xs"] and got.get("os") == node.get("os"), path
        n += 1
    assert n >= 40
