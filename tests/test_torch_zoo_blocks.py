"""The model zoo's blocks in the port against the JAX package, float32 on
the CPU: the Ghost blocks (DWConv, GhostConv, GhostBottleneck at s=1 and
s=2, C3Ghost), the MobileNetV3 blocks (SqueezeExcite, InvertedResidual
with and without SE, ReLU and Hardswish, residual and strided),
Classify, SPP at other kernel sizes and ``ops/experimental.py``
(CrossConv, MixConv2d, Sum with and without weights).

- Params of each block's JAX ``init`` layout drawn with numpy, given
  random BatchNorm statistics with every other conv folded (``torch_parity.randomize_convs``), are
  carried across by ``params_from_jax``; the same seeded input gives
  outputs within 1e-4 of the largest |output|, the tolerance of
  tests/test_torch_families.py.
- ``contract`` / ``expand`` bit-equal to JAX's on distinct values (a
  permuted channel order keeps every shape), and their round trip.
- ``blocks.init_train`` gives each block JAX's ``init`` tree: the same
  keys and shapes, Sum's weights and the rectangular convs' zero biases.
- The int8 recipe refuses a model holding a grouped or ReLU conv.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import nhwc_to_port, port_to_nhwc, randomize_convs, to_numpy
from yolort_tpu.ops import blocks as JB
from yolort_tpu.ops import experimental as JE
from yolort_tpu_torch.models._bridge import params_from_jax, params_to_jax
from yolort_tpu_torch.ops import blocks as TB
from yolort_tpu_torch.ops import experimental as TE
from yolort_tpu_torch.ops import quantization as TQ


def gen():
    return torch.Generator().manual_seed(0)


# name: (JAX block, port block factory, input channels, input (H, W))
CASES = {
    "dwconv_s2": (JB.DWConv(16, 32, 3, 2), lambda: TB.DWConv(16, 32, 3, 2, gen=gen()), 16, (9, 12)),
    "ghostconv": (JB.GhostConv(16, 32, 3, 1), lambda: TB.GhostConv(16, 32, 3, 1, gen=gen()), 16,
                  (8, 12)),
    "ghostbottleneck_s1": (JB.GhostBottleneck(32, 32, 3, 1),
                           lambda: TB.GhostBottleneck(32, 32, 3, 1, gen=gen()), 32, (8, 12)),
    "ghostbottleneck_s2": (JB.GhostBottleneck(16, 32, 3, 2),
                           lambda: TB.GhostBottleneck(16, 32, 3, 2, gen=gen()), 16, (9, 12)),
    "c3ghost": (JB.C3Ghost(16, 32, 2), lambda: TB.C3Ghost(16, 32, 2, gen=gen()), 16, (8, 12)),
    "se": (JB.SqueezeExcite(32, 8), lambda: TB.SqueezeExcite(32, 8, gen=gen()), 32, (8, 12)),
    "ir_se_relu_residual": (JB.InvertedResidual(16, 16, 16, 3, 1, use_se=True, act="relu"),
                            lambda: TB.InvertedResidual(16, 16, 16, 3, 1, use_se=True, act="relu",
                                                        gen=gen()), 16, (8, 12)),
    "ir_relu_strided": (JB.InvertedResidual(16, 72, 24, 3, 2, act="relu"),
                        lambda: TB.InvertedResidual(16, 72, 24, 3, 2, act="relu", gen=gen()), 16,
                        (9, 12)),
    "ir_se_hardswish_residual": (JB.InvertedResidual(24, 96, 24, 5, 1, use_se=True),
                                 lambda: TB.InvertedResidual(24, 96, 24, 5, 1, use_se=True,
                                                             gen=gen()), 24, (8, 12)),
    "ir_hardswish_strided": (JB.InvertedResidual(24, 96, 40, 5, 2),
                             lambda: TB.InvertedResidual(24, 96, 40, 5, 2, gen=gen()), 24, (9, 12)),
    "classify": (JB.Classify(16, 5), lambda: TB.Classify(16, 5, gen=gen()), 16, (8, 12)),
    "spp_3_5_7": (JB.SPP(16, 24, (3, 5, 7)), lambda: TB.SPP(16, 24, (3, 5, 7), gen=gen()), 16,
                  (8, 12)),
    "crossconv_s2": (JE.CrossConv(16, 32, k=3, s=2), lambda: TE.CrossConv(16, 32, 3, 2, gen=gen()),
                     16, (9, 12)),
    "crossconv_shortcut": (JE.CrossConv(16, 16, k=3, shortcut=True),
                           lambda: TE.CrossConv(16, 16, 3, shortcut=True, gen=gen()), 16, (8, 12)),
    "mixconv2d": (JE.MixConv2d(16, 24, k=(1, 3)), lambda: TE.MixConv2d(16, 24, (1, 3), gen=gen()),
                  16, (8, 12)),
    "mixconv2d_remainder": (JE.MixConv2d(16, 25, k=(1, 3, 5)),
                            lambda: TE.MixConv2d(16, 25, (1, 3, 5), gen=gen()), 16, (8, 12)),
}


def numpy_params(init, seed: int):
    """A tree of ``init``'s layout drawn with numpy (eager JAX would compile
    every draw's shape on its own): weights U(-b, b), b = 1/sqrt(fan-in),
    biases U(-0.1, 0.1), BatchNorm at identity."""
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

    return jax.tree_util.tree_map_with_path(draw, jax.eval_shape(init, jax.random.PRNGKey(seed)))


def _rel_err(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name):
    jblock, make, c, (h, w) = CASES[name]
    seed = sorted(CASES).index(name)
    params = randomize_convs(numpy_params(jblock.init, seed), seed)
    x = np.random.default_rng(seed).standard_normal((2, h, w, c)).astype(np.float32)
    want = np.asarray(jblock(params, jnp.asarray(x)))
    port = params_from_jax(params, make())
    with torch.no_grad():
        got = port(nhwc_to_port(x).contiguous(memory_format=torch.channels_last))
    got = got.numpy() if got.ndim == 2 else port_to_nhwc(got)
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("weight", [False, True])
def test_sum_matches_jax(weight):
    jsum = JE.Sum(3, weight=weight)
    params = to_numpy(jsum.init(jax.random.PRNGKey(0)))
    if weight:  # off the init, so that each weight counts
        params["w"] = np.asarray([0.3, -1.2], np.float32)
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((2, 6, 8, 4)).astype(np.float32) for _ in range(3)]
    want = np.asarray(jsum(params, [jnp.asarray(x) for x in xs]))
    port = params_from_jax(params, TE.Sum(3, weight=weight))
    with torch.no_grad():
        got = port_to_nhwc(port([nhwc_to_port(x) for x in xs]))
    assert _rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("gain", [2, 3])
def test_contract_expand_are_jax_bit_for_bit(gain):
    n, h, w, c = 2, 6 * gain, 4 * gain, 5 * gain * gain
    x = np.arange(n * h * w * c, dtype=np.float32).reshape(n, h, w, c)  # every value distinct
    want = np.asarray(JB.contract(jnp.asarray(x), gain))
    got = TB.contract(nhwc_to_port(x), gain)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(port_to_nhwc(got), want)
    want = np.asarray(JB.expand(jnp.asarray(x), gain))
    got = TB.expand(nhwc_to_port(x), gain)
    np.testing.assert_array_equal(port_to_nhwc(got), want)
    t = nhwc_to_port(x)
    assert torch.equal(TB.expand(TB.contract(t, gain), gain), t)
    assert torch.equal(TB.contract(TB.expand(t, gain), gain), t)


def test_activations_are_jax_bit_for_bit():
    """relu and the JAX form of hardsigmoid, clip(x / 6 + 0.5, 0, 1), which
    ``F.hardsigmoid`` rounds differently."""
    x = np.random.default_rng(4).standard_normal(4096).astype(np.float32) * 6
    for name, jfn in (("relu", JB.relu), ("hardsigmoid", JB.hardsigmoid)):
        fn = TB.ACTS["relu"] if name == "relu" else TB.hardsigmoid
        np.testing.assert_array_equal(fn(torch.from_numpy(x)).numpy(), np.asarray(jfn(x)))


def _tree_shapes(tree):
    return {k: _tree_shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in tree.items()}


@pytest.mark.parametrize("name", ["ghostbottleneck_s2", "c3ghost", "ir_se_relu_residual",
                                  "crossconv_s2", "mixconv2d", "classify"])
def test_init_train_is_the_jax_init_tree(name):
    jblock, make, _, _ = CASES[name]
    want = jax.eval_shape(jblock.init, jax.random.PRNGKey(0))
    port = make()
    TB.init_train(port, torch.Generator().manual_seed(1))
    got = params_to_jax(port)
    assert _tree_shapes(got) == _tree_shapes(want)
    if name == "crossconv_s2":
        assert not got["cv1"]["b"].any() and not got["cv2"]["b"].any()
    s = TE.Sum(4, weight=True)
    with torch.no_grad():
        s.w.fill_(1.0)
    TB.init_train(s, torch.Generator())
    np.testing.assert_array_equal(s.w.detach().numpy(), np.asarray(JE.Sum(4, True).init(None)["w"]))


@pytest.mark.parametrize("block", ["ghostconv", "dwconv", "relu_conv"])
def test_int8_recipe_refuses_grouped_and_relu_convs(block):
    model = {"ghostconv": lambda: TB.GhostConv(16, 32, gen=gen()),
             "dwconv": lambda: TB.DWConv(32, 64, 5, gen=gen()),
             "relu_conv": lambda: TB.Conv(16, 32, 3, act="relu", gen=gen())}[block]()
    for m in model.modules():
        if isinstance(m, TB.Conv):
            m._absmax = m._out_absmax = 1.0  # as calibrate_activations marks them
    with pytest.raises(ValueError, match="int8 of grouped and ReLU convs is not ported"):
        TQ.quantize_compute_params(model)
    assert not any(isinstance(m, TB.Conv) and m.quantized for m in model.modules())
