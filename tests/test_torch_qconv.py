"""The port's int8 convolution against the JAX package, on the CPU.

The plain versions ``qconv1x1_reference`` / ``qconv_kxk_reference`` are held
against the Pallas ``qconv`` in interpret mode, and the port's quantized
Conv against the JAX ``blocks.Conv`` on int8 params (the XLA ``_conv_int8``
path, which also runs the strided convs and the 6x6 stem).  The s32
accumulator is exact on both sides, so int8 outputs must be identical.
Float outputs: against the eager XLA path the epilogue rounds the same
operations in the same order and agrees to 1e-6 relative (torch's and
XLA's sigmoids differ by up to 2 ulp on about 0.4% of inputs; an int8
output flips only if such an ulp crosses a rounding boundary, which these
seeded inputs do not).  The interpret-mode Pallas kernel runs jitted, and
there XLA contracts ``acc * scale + bias`` into one FMA where the port
rounds the product first; that one rounding, at most
6e-8 * |acc * scale| < 1e-6 at these scales, is the atol of that
comparison (as tests/test_qconv.py allows).

The wrappers' own checks and their kernel-against-plain cases (``cuda``
marker) are in tests/test_torch_kernels_cpu.py, which imports no JAX."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import nhwc_to_port, port_to_nhwc
from yolort_tpu.ops import blocks as JB
from yolort_tpu.ops.pallas import qconv as JQ
from yolort_tpu_torch.models._bridge import params_from_jax
from yolort_tpu_torch.ops import blocks as TB
from yolort_tpu_torch.ops.cuda import qconv1x1_reference, qconv_kxk_reference
from yolort_tpu_torch.ops.cuda.qconv_kernel import pack_weight

# the shapes of tests/test_qconv.py: (k, n, h, w, c, cout)
CASES = [
    (1, 2, 12, 12, 32, 64),
    (3, 2, 12, 12, 32, 64),
    (3, 1, 8, 10, 16, 32),
    (3, 2, 16, 16, 64, 32),
]


def _operands(k, n, h, w, c, co, seed):
    rng = np.random.default_rng(seed)
    xq = rng.integers(-127, 128, (n, h, w, c), dtype=np.int8)
    wq = rng.integers(-10, 11, (k, k, c, co), dtype=np.int8)
    scale = rng.uniform(1e-4, 1e-3, (co,)).astype(np.float32)
    bias = rng.uniform(-1, 1, (co,)).astype(np.float32)
    return xq, wq, scale, bias


def _port(xq, wq, scale, bias, device="cpu"):
    return (nhwc_to_port(xq).contiguous(memory_format=torch.channels_last).to(device),
            pack_weight(wq).to(device), torch.from_numpy(scale).to(device),
            torch.from_numpy(bias).to(device))


def _plain(k, *args, **kw):
    if k == 1:
        return qconv1x1_reference(*args, **kw)
    return qconv_kxk_reference(*args, k=k, **kw)


@pytest.mark.parametrize("k,n,h,w,c,co", CASES)
@pytest.mark.parametrize("act", ["silu", "none"])
def test_plain_versions_match_pallas_interpret(k, n, h, w, c, co, act):
    xq, wq, scale, bias = _operands(k, n, h, w, c, co, seed=k * 100 + c)
    args = _port(xq, wq, scale, bias)
    jargs = tuple(jnp.asarray(a) for a in (xq, wq, scale, bias))

    want = np.asarray(JQ.qconv(*jargs, k=k, act=act, inv_out_scale=jnp.float32(6.0),
                               interpret=True))
    got = _plain(k, *args, act=act, inv_out_scale=6.0)
    assert got.dtype == torch.int8 and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(port_to_nhwc(got), want)

    wantf = np.asarray(JQ.qconv(*jargs, k=k, act=act, inv_out_scale=None,
                                out_dtype=jnp.float32, interpret=True))
    gotf = _plain(k, *args, act=act, inv_out_scale=None, out_dtype=torch.float32)
    assert gotf.dtype == torch.float32
    np.testing.assert_allclose(port_to_nhwc(gotf), wantf, rtol=1e-6, atol=1e-6)


def _int8_leaf(k, cin, cout, seed, os=True):
    rng = np.random.default_rng(seed)
    p = {
        "wq": rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8),
        "ws": rng.uniform(2e-4, 2e-3, (cout,)).astype(np.float32),
        "xs": float(np.float32(rng.uniform(0.005, 0.01))),
        "b": rng.uniform(-0.5, 0.5, (cout,)).astype(np.float32),
    }
    if os:
        p["os"] = float(np.float32(rng.uniform(0.02, 0.05)))
    return p


def _jax_leaf(p):
    return {key: JB.StaticScale(v) if isinstance(v, float) else jnp.asarray(v)
            for key, v in p.items()}


@pytest.mark.parametrize("k,s,p,cin,shape", [
    (6, 2, 2, 3, (2, 64, 48, 3)),    # the r6.0 stem (K = 108, C % 4 != 0)
    (3, 2, None, 32, (2, 20, 14, 32)),  # a downsample
    (3, 1, None, 32, (2, 10, 12, 32)),  # a Bottleneck's 3x3
    (1, 1, None, 64, (2, 9, 11, 64)),   # a 1x1
])
@pytest.mark.parametrize("quantized_input", [False, True])
def test_int8_conv_matches_jax(k, s, p, cin, shape, quantized_input):
    leaf = _int8_leaf(k, cin, 48, seed=k * 10 + s)
    jb = JB.Conv(cin, 48, k=k, s=s, p=p)
    tb = TB.Conv(cin, 48, k=k, s=s, p=p, gen=torch.Generator().manual_seed(0))
    params_from_jax(leaf, tb)
    assert tb.quantized and not list(tb.parameters())
    rng = np.random.default_rng(7)
    if quantized_input:
        q = rng.integers(-127, 128, shape, dtype=np.int8)
        jx = JB.QTensor(jnp.asarray(q), JB.StaticScale(0.0123), jnp.zeros((0,), jnp.float32))
        tx = TB.QTensor(nhwc_to_port(q).contiguous(memory_format=torch.channels_last), 0.0123,
                        torch.float32)
    else:
        x = rng.uniform(-1.2, 1.2, shape).astype(np.float32)
        jx, tx = jnp.asarray(x), nhwc_to_port(x)
    want = jb(_jax_leaf(leaf), jx)
    got = tb(tx)
    assert isinstance(got, TB.QTensor) and got.s == leaf["os"] and got.dtype == torch.float32
    assert got.q.dtype == torch.int8 and got.q.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(port_to_nhwc(got.q), np.asarray(want.q))


def test_int8_conv2d_only_writes_float_logits():
    leaf = _int8_leaf(1, 64, 255, seed=3, os=False)
    jb = JB.Conv2dOnly(64, 255, 1)
    tb = TB.Conv2dOnly(64, 255, 1, gen=torch.Generator().manual_seed(0))
    params_from_jax(leaf, tb)
    q = np.random.default_rng(8).integers(-127, 128, (2, 5, 7, 64), dtype=np.int8)
    want = jb(_jax_leaf(leaf), JB.QTensor(jnp.asarray(q), JB.StaticScale(0.02),
                                          jnp.zeros((0,), jnp.float32)))
    got = tb(TB.QTensor(nhwc_to_port(q).contiguous(memory_format=torch.channels_last), 0.02,
                        torch.float32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(port_to_nhwc(got), np.asarray(want), rtol=1e-6, atol=0)
