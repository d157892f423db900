"""Selection on float bit patterns: port against JAX, bit for bit.

Covers the k-th value search, the stage-1 index screen, the stage-2
threshold select, and the plain versions of the two lookup kernels against
the Pallas kernels run in interpret mode.  Cases include ties, fewer valid
entries than k, and none valid."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolort_tpu.ops import select as JS
from yolort_tpu.ops.pallas.lookup_kernel import pallas_bisect_count, pallas_row_fetch
from yolort_tpu_torch.ops import select as TS
from yolort_tpu_torch.ops.cuda import bisect_count_reference, row_fetch_reference


def scores(seed, shape, kind="sig", valid_frac=1.0):
    rng = np.random.default_rng(seed)
    if kind == "ties":  # few distinct values: many boundary ties
        s = rng.integers(0, 40, shape).astype(np.float32) / 40.0
    else:
        a, c = rng.standard_normal(shape) * 2 - 1, rng.standard_normal(shape) * 2 - 1
        s = ((1 / (1 + np.exp(-a))) * (1 / (1 + np.exp(-c)))).astype(np.float32)
    flat = s.reshape(shape[0], -1)
    flat[:, int(flat.shape[1] * valid_frac):] = 0.0
    return s


CASES = [  # (kind, valid_frac, k, thresh)
    ("sig", 1.0, 300, 0.25),
    ("sig", 1.0, 1000, 0.005),
    ("ties", 1.0, 257, 0.1),
    ("sig", 0.01, 500, 0.25),   # fewer valid entries than k
    ("sig", 1.0, 64, 0.999),    # none valid
    ("sig", 1.0, 5000, 0.0),    # k beyond n
]


@pytest.mark.parametrize("kind,frac,k,thr", CASES)
def test_bisect_kth_bits_bit_identical(kind, frac, k, thr):
    s = scores(1, (3, 2000), kind, frac)
    bits = s.view(np.int32)
    thr_bits = np.float32(thr).view(np.int32)
    fn = jax.jit(lambda b: JS._bisect_kth_bits(b, b > thr_bits, min(k, bits.shape[1])))
    want = np.stack([np.asarray(fn(jnp.asarray(b))) for b in bits])
    tb = torch.from_numpy(bits)
    got = TS._bisect_kth_bits(tb, tb > int(thr_bits), min(k, bits.shape[1]))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind,frac,k,thr", CASES)
def test_select_topk_indices_bit_identical(kind, frac, k, thr):
    s = scores(2, (3, 1500), kind, frac)
    ok, idx = TS.select_topk_indices(torch.from_numpy(s), k, thr)
    fn = jax.jit(lambda x: JS.select_topk_indices(x, k, thr))
    for b in range(s.shape[0]):
        jok, jidx = fn(jnp.asarray(s[b]))
        np.testing.assert_array_equal(ok[b].numpy(), np.asarray(jok))
        np.testing.assert_array_equal(idx[b].numpy()[ok[b].numpy()], np.asarray(jidx)[np.asarray(jok)])


@pytest.mark.parametrize("seed,n", [(3, 3000), (7, 1111)])
@pytest.mark.parametrize("kind,frac,k,thr", CASES)
def test_select_topk_threshold_bit_identical(kind, frac, k, thr, seed, n):
    s = scores(seed, (2, n), kind, frac)  # n = 1111: a partial last chunk
    vals, idx = TS.select_topk_threshold(torch.from_numpy(s), k, thr)
    fn = jax.jit(lambda x: JS.select_topk_threshold(x, k, thr))
    for b in range(s.shape[0]):
        jv, ji = fn(jnp.asarray(s[b]))
        np.testing.assert_array_equal(vals[b].numpy().view(np.int32), np.asarray(jv).view(np.int32))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))


@pytest.mark.parametrize("kind,frac,k,thr", CASES)
def test_bisect_count_reference_matches_pallas(kind, frac, k, thr):
    s = scores(4, (2, 40, 128), kind, frac)
    thr_bits = int(np.float32(thr).view(np.int32))
    t, cg, ce = bisect_count_reference(torch.from_numpy(s), k, thr_bits)
    for b in range(s.shape[0]):
        jt, jcg, jce = pallas_bisect_count(jnp.asarray(s[b]), k, thr_bits, interpret=True)
        assert int(t[b]) == int(jt)
        np.testing.assert_array_equal(cg[b].numpy(), np.asarray(jcg))
        np.testing.assert_array_equal(ce[b].numpy(), np.asarray(jce))


@pytest.mark.parametrize("kind,k", [("sig", 4104), ("sig", 520), ("ties", 4104)])
def test_bisect_count_reference_matches_pallas_at_stage1_shape(kind, k):
    """The stage-1 anchor screen's table at 640: 25,200 anchors are a
    (197, 128) table, k1 = 4104 (eval) or 520 (serving), threshold 0."""
    s = scores(5, (2, 197, 128), kind)
    t, cg, ce = bisect_count_reference(torch.from_numpy(s), k, 0)
    for b in range(s.shape[0]):
        jt, jcg, jce = pallas_bisect_count(jnp.asarray(s[b]), k, 0, interpret=True)
        assert int(t[b]) == int(jt)
        np.testing.assert_array_equal(cg[b].numpy(), np.asarray(jcg))
        np.testing.assert_array_equal(ce[b].numpy(), np.asarray(jce))
    assert int(cg.sum() + ce.sum()) >= 2 * k  # the k-th value's tier reaches k


def _special_table(seed, m, w):
    specials = np.asarray(
        [0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, np.float32(1e-45), np.float32(-1e-45),
         np.float32(3.4e38), np.float32(-3.4e38), np.float32(0.005), np.float32(1e-8)], np.float32)
    tab = np.random.default_rng(seed).standard_normal((m, w)).astype(np.float32)
    tab[: len(specials), 0] = specials
    tab[: len(specials), w - 1] = specials[::-1]
    tab[20, 2] = np.int32(-(2**31)).view(np.float32)
    tab[21, 2] = np.int32(2**31 - 1).view(np.float32)
    tab[22, 2] = np.int32(0x7FC00123).view(np.float32)  # NaN payload
    return tab


@pytest.mark.parametrize("m,w,k", [(160, 128, 512), (77, 4, 600)])
def test_row_fetch_reference_matches_pallas_special_values(m, w, k):
    rng = np.random.default_rng(m)
    tabs = np.stack([_special_table(s, m, w) for s in (0, 1)])
    phys = rng.integers(-3, m + 3, (2, k)).astype(np.int32)  # out of range clamps
    phys[:, :30] = np.arange(30)
    got = row_fetch_reference(torch.from_numpy(tabs), torch.from_numpy(phys))
    for b in range(2):
        want = np.asarray(pallas_row_fetch(jnp.asarray(tabs[b]), jnp.asarray(phys[b]), interpret=True))
        np.testing.assert_array_equal(got[b].numpy().view(np.int32), want[:, :w].view(np.int32))


@pytest.mark.parametrize("m", [128, 50])
def test_row_fetch_reference_bf16_bits(m):
    """bf16 rows keep every bit, NaN payloads included.  The JAX kernel
    loses a bf16 NaN payload when it pads the table to 128 rows (jnp.pad
    quiets it on the CPU), so it is the oracle only at m = 128; plain
    int16 indexing is the oracle at every m."""
    rng = np.random.default_rng(9)
    tab = torch.from_numpy(rng.standard_normal((2, m, 128)).astype(np.float32)).to(torch.bfloat16)
    tab.view(torch.int16)[:, 3, 7] = 0x7FC1  # NaN payload
    phys = rng.integers(-2, m + 2, (2, 300)).astype(np.int32)
    phys[:, 0] = 3
    got = row_fetch_reference(tab, torch.from_numpy(phys)).view(torch.int16).numpy()
    bits = tab.view(torch.int16).numpy()
    for b in range(2):
        np.testing.assert_array_equal(got[b], bits[b][np.clip(phys[b], 0, m - 1)])
        if m == 128:
            jtab = jax.lax.bitcast_convert_type(jnp.asarray(bits[b]), jnp.bfloat16)
            want = pallas_row_fetch(jtab, jnp.asarray(phys[b]), interpret=True)
            np.testing.assert_array_equal(got[b], np.asarray(jax.lax.bitcast_convert_type(want, jnp.int16)))


@pytest.mark.parametrize("dtype,w", [(np.float32, 128), ("bfloat16", 85), ("bfloat16", 255)])
def test_row_fetch_reference_matches_pallas_on_sorted_runs(dtype, w):
    """The main path's index shape: two index-ordered runs (stage 2's gt
    then eq tier) with repeats and out-of-range ends, at the stage-2 width
    and the bf16 widths of the cells rows (85, and 255 across two 128-lane
    column groups).  bf16 tables here hold no NaN (see
    test_row_fetch_reference_bf16_bits)."""
    rng = np.random.default_rng(w)
    m, k = 300, 520
    tab32 = rng.standard_normal((2, m, w)).astype(np.float32)
    tab32[:, 4, 0] = -0.0
    phys = np.concatenate([np.sort(rng.integers(-3, m // 2, (2, 400)), 1),
                           np.sort(rng.integers(0, m + 3, (2, k - 400)), 1)], 1).astype(np.int32)
    if dtype == "bfloat16":
        tab = torch.from_numpy(tab32).to(torch.bfloat16)
        bits = tab.view(torch.int16).numpy()
        got = row_fetch_reference(tab, torch.from_numpy(phys)).view(torch.int16).numpy()
    else:
        bits = tab32.view(np.int32)
        got = row_fetch_reference(torch.from_numpy(tab32), torch.from_numpy(phys)).numpy().view(np.int32)
    for b in range(2):
        np.testing.assert_array_equal(got[b], bits[b][np.clip(phys[b], 0, m - 1)])
        if dtype == "bfloat16":
            jtab = jax.lax.bitcast_convert_type(jnp.asarray(bits[b]), jnp.bfloat16)
            want = pallas_row_fetch(jtab, jnp.asarray(phys[b]), interpret=True)
            want = np.asarray(jax.lax.bitcast_convert_type(want, jnp.int16))
        else:
            want = np.asarray(pallas_row_fetch(jnp.asarray(tab32[b]), jnp.asarray(phys[b]),
                                               interpret=True)).view(np.int32)
        np.testing.assert_array_equal(got[b], want[:, :w])
