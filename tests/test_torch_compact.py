"""Stream-compaction top-k: the port's ``compact_select`` (the plain version
of ``compact_place`` on CPU tensors) against JAX ``compact_select`` in
interpret mode, in the cases of ``tests/test_compact_kernel.py``, and
against the port's ``select_topk_threshold``.  Values and indices
identical (n < 2^24, where the JAX kernel's float32 indices are exact)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolort_tpu.ops.pallas.compact_kernel import compact_select as jax_compact_select
from yolort_tpu_torch.ops.cuda import bisect_count_reference, compact_place, compact_place_reference
from yolort_tpu_torch.ops.select import compact_select, select_topk_threshold
from tests.test_torch_kernels_cpu import COMPACT_CASES, COMPACT_THRESH, compact_scores


def scores(dist, n, seed=0, batch=2):
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        x = rng.random((batch, n), dtype=np.float32)
    elif dist == "sparse":
        x = rng.random((batch, n), dtype=np.float32) * 0.004
        for b in range(batch):
            x[b, rng.choice(n, 50, replace=False)] = rng.random(50).astype(np.float32)
    elif dist == "ties":
        x = np.round(rng.random((batch, n)).astype(np.float32) * 20) / 20
    else:  # almost everything below the threshold
        x = rng.random((batch, n), dtype=np.float32) * 0.004
    return x


DISTS = ["uniform", "sparse", "ties", "subthreshold"]


@pytest.mark.parametrize("dist", DISTS)
def test_compact_select_matches_jax(dist):
    n, k, thr = 40960, 512, 0.005
    x = scores(dist, n)
    vals, idx = compact_select(torch.from_numpy(x), k, thr)
    uvals, uidx = compact_select(torch.from_numpy(x), k, thr, sort=False)
    for b in range(x.shape[0]):
        jv, ji = jax_compact_select(jnp.asarray(x[b]), k, thr, interpret=True)
        np.testing.assert_array_equal(vals[b].numpy().view(np.int32), np.asarray(jv).view(np.int32))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
        jv, ji = jax_compact_select(jnp.asarray(x[b]), k, thr, sort=False, interpret=True)
        np.testing.assert_array_equal(uvals[b].numpy().view(np.int32), np.asarray(jv).view(np.int32))
        np.testing.assert_array_equal(uidx[b].numpy(), np.asarray(ji))


@pytest.mark.parametrize("dist", DISTS)
@pytest.mark.parametrize("n,k", [(325 * 128, 512), (3000, 4096), (1111, 64)])
def test_compact_select_equals_select_topk_threshold(dist, n, k):
    x = torch.from_numpy(scores(dist, n, seed=n))
    for thr in (0.005, 0.25):
        got = compact_select(x, k, thr)
        want = select_topk_threshold(x, k, thr)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_compact_place_reference_positions():
    """gt-tier entries then eq-tier entries, each in index order, truncated
    at k; the slots past the total hold (0.0, 0)."""
    row = np.zeros((1, 2, 128), np.float32)
    row[0, 0, [3, 9]] = 0.5    # chunk 0: two ties around a gt entry (lane 5)
    row[0, 0, 5] = 0.9
    row[0, 1, [0, 7]] = [0.5, 0.7]
    tab = torch.from_numpy(row)
    thr = int(np.float32(0.1).view(np.int32))
    t, cg, ce = bisect_count_reference(tab, 4, thr)
    assert int(t) == int(np.float32(0.5).view(np.int32))
    cnt = torch.cat([cg, ce], 1)
    off = cnt.cumsum(1, dtype=torch.int32) - cnt
    vals, idx = compact_place(tab, cnt, off, t, thr, 5)  # CPU: the plain version
    assert idx.tolist() == [[5, 128 + 7, 3, 9, 128]] and vals[0, 0] == np.float32(0.9)
    vals, idx = compact_place_reference(tab, cnt, off, t, thr, 3)
    assert idx.tolist() == [[5, 135, 3]]
    vals, idx = compact_place(tab, cnt, off, t, thr, 8)
    assert idx[0, 5:].tolist() == [0, 0, 0] and vals[0, 5:].tolist() == [0.0, 0.0, 0.0]


@pytest.mark.parametrize("name", list(COMPACT_CASES))
def test_compact_select_matches_jax_where_the_kernel_is_hard(name):
    """The cases the placement kernel makes hard (tests/test_torch_kernels_cpu.py
    holds the kernel against this plain version on them): a chunk all in
    the gt tier, a chunk holding both tiers, the eq tier straddling k, an
    empty tail, no valid entry, one chunk and a warp's 32-chunk run plus
    one; sorted and unsorted."""
    _, k = COMPACT_CASES[name]
    x = compact_scores(name, 2)
    for sort in (True, False):
        vals, idx = compact_select(torch.from_numpy(x), k, COMPACT_THRESH, sort=sort)
        for b in range(x.shape[0]):
            jv, ji = jax_compact_select(jnp.asarray(x[b]), k, COMPACT_THRESH, sort=sort,
                                        interpret=True)
            np.testing.assert_array_equal(vals[b].numpy().view(np.int32), np.asarray(jv).view(np.int32))
            np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))
