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
from yolort_tpu_torch.ops.cuda import qconv, qconv1x1_reference, qconv_kxk_reference
from yolort_tpu_torch.ops.cuda.qconv_kernel import (
    BK, MAX_DEPTH, MAX_SMEM, TILES, pack_weight, padded_depth, qconv_plan, tile_smem,
)

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


# the 29 distinct int8 conv shapes of yolov5s r6.0 at 640, as (k, stride,
# pad, cin, cout, input side): 11 kxk (the stem, 6 downsamples, 4 bottleneck
# 3x3s) and 18 1x1 (C3 cv1/cv2/cv3 and bottleneck cv1, SPPF, the PAN
# laterals, the three head convs with Cout 255)
YOLOV5S_CONVS = [
    (6, 2, 2, 3, 32, 640), (3, 2, 1, 32, 64, 320), (3, 1, 1, 32, 32, 160),
    (3, 2, 1, 64, 128, 160), (3, 1, 1, 64, 64, 80), (3, 2, 1, 128, 256, 80),
    (3, 1, 1, 128, 128, 40), (3, 2, 1, 256, 512, 40), (3, 1, 1, 256, 256, 20),
    (3, 2, 1, 128, 128, 80), (3, 2, 1, 256, 256, 40),
    (1, 1, 0, 64, 32, 160), (1, 1, 0, 32, 32, 160), (1, 1, 0, 64, 64, 160),
    (1, 1, 0, 128, 64, 80), (1, 1, 0, 64, 64, 80), (1, 1, 0, 128, 128, 80),
    (1, 1, 0, 256, 64, 80), (1, 1, 0, 128, 255, 80),
    (1, 1, 0, 256, 128, 40), (1, 1, 0, 128, 128, 40), (1, 1, 0, 256, 256, 40),
    (1, 1, 0, 512, 128, 40), (1, 1, 0, 256, 255, 40),
    (1, 1, 0, 512, 256, 20), (1, 1, 0, 256, 256, 20), (1, 1, 0, 512, 512, 20),
    (1, 1, 0, 1024, 512, 20), (1, 1, 0, 512, 255, 20),
]


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_tile_plan_covers_every_yolov5s_conv(batch):
    assert len(set(YOLOV5S_CONVS)) == 29
    small_tile = 0
    for k, s, p, cin, cout, side in YOLOV5S_CONVS:
        out_side = (side + 2 * p - k) // s + 1
        m, kpad = batch * out_side ** 2, padded_depth(k, cin)
        plan = qconv_plan(m, cout, k * k * cin, cin, kpad)
        bm, bn = TILES[plan.tile]
        assert (plan.bm, plan.bn) == (bm, bn) and plan.smem == tile_smem(bm, bn) <= MAX_SMEM
        # the K slabs tile Kpad with the tail (zero-filled by the loader)
        # shorter than a slab, and the tiles cover every output
        assert plan.slabs * BK >= kpad > (plan.slabs - 1) * BK
        assert plan.tiles[0] * bm >= m > (plan.tiles[0] - 1) * bm
        assert plan.tiles[1] * bn >= cout > (plan.tiles[1] - 1) * bn
        assert plan.gather == (cin % 16 != 0 or kpad % 16 != 0)
        assert plan.gather == (k == 6)  # the stem only, on its 128 x 32 tile
        if plan.gather:
            assert (bm, bn) == (128, 32)
            continue
        # 64-row tiles exactly where 128-row tiles would be fewer than the
        # 132 SMs
        assert (bm == 64) == (-(-m // 128) * -(-cout // bn) < 132 or bn < min(128, max(32, cout)))
        small_tile += bm == 64 and out_side == 20
    if batch == 8:  # every 20x20 layer (M = 3200) takes a 64-row tile
        assert small_tile == sum(1 for c in YOLOV5S_CONVS
                                 if (c[5] + 2 * c[2] - c[0]) // c[1] + 1 == 20)
    # a misaligned pointer takes the gather loader too
    assert qconv_plan(3200, 256, 2304, 256, 2304, aligned=False)[:4] == (2, 128, 32, True)


@pytest.mark.parametrize("k,c", [(1, 2304), (3, 256)])
def test_plain_versions_match_pallas_interpret_at_the_extreme_accumulator(k, c):
    """All activations +127 and all weights +127 or -127 at K = 2304: the
    accumulator reaches +-K * 127^2 = +-37,161,216, which float32 holds
    exactly, so with scale 1 and bias 0 both sides return it exactly."""
    n, h, w, co = 1, 6, 7, 16
    xq = np.full((n, h, w, c), 127, np.int8)
    wq = np.full((k, k, c, co), 127, np.int8)
    wq[..., 1::2] = -127
    assert k * k * c == 2304
    for scale, bias, act, ios in ((1.0, 0.0, "none", None), (2.0 ** -20, 0.25, "silu", 2.0)):
        sc = np.full((co,), scale, np.float32)
        bi = np.full((co,), bias, np.float32)
        jargs = tuple(jnp.asarray(a) for a in (xq, wq, sc, bi))
        want = np.asarray(JQ.qconv(*jargs, k=k, act=act, out_dtype=jnp.float32, interpret=True,
                                   inv_out_scale=None if ios is None else jnp.float32(ios)))
        got = port_to_nhwc(_plain(k, *_port(xq, wq, sc, bi), act=act, inv_out_scale=ios,
                                  out_dtype=torch.float32))
        np.testing.assert_array_equal(got, want)
        if ios is None:
            extreme = 2304 * 127 * 127
            np.testing.assert_array_equal(got[:, 1:-1, 1:-1, 0::2], extreme)
            np.testing.assert_array_equal(got[:, 1:-1, 1:-1, 1::2], -extreme)


def test_wrappers_refuse_an_accumulator_that_could_reach_2_31():
    c = MAX_DEPTH + 1  # K * 128^2 >= 2^31
    xq = torch.zeros((1, c, 1, 1), dtype=torch.int8).contiguous(memory_format=torch.channels_last)
    ok = torch.zeros((1, MAX_DEPTH - MAX_DEPTH % 4), dtype=torch.int8)
    one = torch.ones(1, dtype=torch.float32)
    qconv(xq[:, : ok.shape[1]], ok, one, one, k=1, inv_out_scale=1.0)  # the largest K runs
    for k, wq in ((1, torch.zeros((1, padded_depth(1, c)), dtype=torch.int8)),
                  (3, torch.zeros((1, padded_depth(3, c)), dtype=torch.int8))):
        with pytest.raises(ValueError, match="2\\^31"):
            qconv(xq, wq, one, one, k=k, inv_out_scale=1.0)
