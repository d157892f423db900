"""Port blocks against the JAX blocks, f32 on the CPU.

Tolerance atol 1e-5, rtol 1e-4: the two frameworks sum the convolutions
in different orders."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import nhwc_to_port, port_to_nhwc, randomize_convs
from yolort_tpu.ops import blocks as JB
from yolort_tpu_torch.models._bridge import params_from_jax
from yolort_tpu_torch.ops import blocks as TB

TOL = dict(atol=1e-5, rtol=1e-4)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(jblock, tblock, seed):
    params = randomize_convs({"blk": jblock.init(jax.random.PRNGKey(seed))}, seed)["blk"]
    params_from_jax(params, tblock)
    return params


def _run(jblock, tblock, params, x):
    want = np.asarray(jblock(params, jnp.asarray(x)))
    with torch.no_grad():
        got = port_to_nhwc(tblock(nhwc_to_port(x)))
    return got, want


@pytest.mark.parametrize("k,s,p,fused", [
    (1, 1, None, True), (1, 1, None, False), (3, 1, None, False), (3, 2, None, True),
    (6, 2, 2, False), (6, 2, 2, True),
])
def test_conv_both_param_forms(k, s, p, fused):
    gen = torch.Generator().manual_seed(0)
    jb = JB.Conv(8, 16, k=k, s=s, p=p)
    tb = TB.Conv(8, 16, k=k, s=s, p=p, gen=gen)
    params = {key: np.asarray(v) for key, v in jb.init(jax.random.PRNGKey(k + s)).items()}
    rng = np.random.default_rng(k)
    params.update(gamma=rng.uniform(0.5, 1.5, 16).astype(np.float32),
                  beta=rng.standard_normal(16).astype(np.float32) * 0.1,
                  mean=rng.standard_normal(16).astype(np.float32) * 0.1,
                  var=rng.uniform(0.5, 1.5, 16).astype(np.float32))
    if fused:
        w, b = JB.fuse_conv_bn(params["w"], params["gamma"], params["beta"], params["mean"], params["var"])
        params = {"w": w, "b": b}
    params_from_jax(params, tb)
    got, want = _run(jb, tb, params, _x(1, (2, 24, 20, 8)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("shortcut,n", [(True, 1), (False, 2)])
def test_c3(shortcut, n):
    jb = JB.C3(16, 16, n=n, shortcut=shortcut)
    tb = TB.C3(16, 16, n=n, shortcut=shortcut, gen=torch.Generator().manual_seed(0))
    params = _pair(jb, tb, n)
    got, want = _run(jb, tb, params, _x(2, (2, 12, 16, 16)))
    np.testing.assert_allclose(got, want, **TOL)


def test_sppf():
    jb = JB.SPPF(32, 32)
    tb = TB.SPPF(32, 32, gen=torch.Generator().manual_seed(0))
    params = _pair(jb, tb, 3)
    got, want = _run(jb, tb, params, _x(3, (2, 10, 14, 32)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("k", [5, 9])
def test_max_pool_same_pads_with_neg_inf(k):
    x = _x(4, (2, 11, 7, 3)) - 5.0  # all negative: a zero pad would show
    want = np.asarray(JB.max_pool_same(jnp.asarray(x), k))
    got = port_to_nhwc(TB.max_pool_same(nhwc_to_port(x), k))
    np.testing.assert_array_equal(got, want)


def test_upsample2x():
    x = _x(5, (2, 5, 6, 4))
    want = np.asarray(JB.upsample2x(jnp.asarray(x)))
    got = port_to_nhwc(TB.upsample2x(nhwc_to_port(x)))
    np.testing.assert_array_equal(got, want)


def test_autopad_and_eps():
    assert TB.BN_EPS == JB.BN_EPS
    for k, p in ((1, None), (3, None), (6, 2), (5, 0)):
        assert TB.autopad(k, p) == JB.autopad(k, p)
