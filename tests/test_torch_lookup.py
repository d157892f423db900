"""The stage-2 lookup kernels and routes: port against JAX, bit for bit.

``lookup_fetch_reference`` and ``select_extract_reference`` (the plain
versions of the port's kernels) against the Pallas
``pallas_lookup_fetch`` / ``pallas_select_extract`` in interpret mode on
the same chunk tables and offsets, with random, tied, sparse, empty and
dense tables (m <= 325).  Then ``select_topk_threshold`` on each ``row_gather``
route against the JAX function on the same route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolort_tpu.ops import select as JS
from yolort_tpu.ops.pallas.lookup_kernel import pallas_lookup_fetch, pallas_select_extract
from yolort_tpu_torch.ops import select as TS
from yolort_tpu_torch.ops.cuda import (
    bisect_count_reference, lookup_fetch, lookup_fetch_reference, select_extract,
    select_extract_reference,
)


def table(seed, m, case, batch=2):
    """(B, m, 128) f32 scores in [0, 1)."""
    rng = np.random.default_rng(seed)
    n = m * 128
    if case == "random":
        x = rng.uniform(0, 1, (batch, n))
    elif case == "ties":  # few distinct values: boundary tie storms
        x = np.full((batch, n), 0.25)
        x[:, rng.integers(0, n, 300)] = 0.5
    elif case == "few":  # fewer entries above the threshold than k
        x = np.zeros((batch, n))
        x[:, rng.integers(0, n, 23)] = rng.uniform(0.1, 0.9, 23)
    elif case == "dense":  # every entry valid, descending: the top k fill whole chunk rows
        x = np.stack([np.linspace(0.99 - 0.1 * b / batch, 0.5, n) for b in range(batch)])
    else:  # nothing above the threshold
        x = np.zeros((batch, n))
    return x.astype(np.float32).reshape(batch, m, 128)


CASES = ["random", "ties", "few", "empty", "dense"]
SHAPES = [(325, 512, 0.25), (40, 300, 0.005)]  # (m, k, threshold): serving table, a small one


def offsets(tab, k, thr_bits):
    t, cg, ce = bisect_count_reference(torch.from_numpy(tab), k, thr_bits)
    cnt = torch.cat([cg, ce], 1)
    return t, (cnt.cumsum(1, dtype=torch.int32) - cnt).contiguous()


def thr_bits_of(thr):
    return int(np.float32(thr).view(np.int32))


@pytest.mark.parametrize("m,k,thr", SHAPES)
@pytest.mark.parametrize("case", CASES)
def test_lookup_fetch_reference_matches_pallas(case, m, k, thr):
    tab = table(m, m, case)
    _, off = offsets(tab, k, thr_bits_of(thr))
    rows, phys, p, is_eq = lookup_fetch(torch.from_numpy(tab), off, k)  # CPU: the plain version
    assert (rows.dtype, phys.dtype, p.dtype, is_eq.dtype) == (torch.float32, torch.int32, torch.int32, torch.bool)
    for b in range(tab.shape[0]):
        jr, jphys, jp, jeq = pallas_lookup_fetch(jnp.asarray(tab[b]), jnp.asarray(off[b].numpy()), k,
                                                 interpret=True)
        np.testing.assert_array_equal(rows[b].numpy().view(np.int32), np.asarray(jr).view(np.int32))
        np.testing.assert_array_equal(phys[b].numpy(), np.asarray(jphys))
        np.testing.assert_array_equal(p[b].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(is_eq[b].numpy(), np.asarray(jeq))


def test_lookup_fetch_repeated_offsets_take_the_last_chunk():
    """Chunks with a zero count repeat their offset: a slot lands on the
    last chunk whose offset is <= s; slots past the total land on 2m-1."""
    tab = torch.arange(4 * 128, dtype=torch.float32).reshape(1, 4, 128)
    off = torch.tensor([[0, 0, 3, 3, 3, 5, 5, 5]], dtype=torch.int32)  # counts 0,3,0,0,2,0,0,0
    rows, phys, p, is_eq = lookup_fetch_reference(tab, off, 7)
    assert phys.tolist() == [[1, 1, 1, 0, 0, 3, 3]]
    assert is_eq.tolist() == [[False, False, False, True, True, True, True]]
    assert p.tolist() == [[0, 1, 2, 0, 1, 0, 1]]
    assert torch.equal(rows[0, 3], tab[0, 0]) and torch.equal(rows[0, 6], tab[0, 3])


@pytest.mark.parametrize("m,k,thr", SHAPES)
@pytest.mark.parametrize("case", CASES)
def test_select_extract_reference_matches_pallas(case, m, k, thr):
    tab = table(m + 1, m, case)
    tb = thr_bits_of(thr)
    t, off = offsets(tab, k, tb)
    _, phys, p, is_eq = lookup_fetch_reference(torch.from_numpy(tab), off, k)
    # a second set of slots whose ranks and rows miss: no hit gives (0.0, 0)
    rng = np.random.default_rng(m)
    phys2 = torch.from_numpy(rng.integers(-2, m + 2, phys.shape).astype(np.int32))
    p2 = torch.from_numpy(rng.integers(-2, 130, p.shape).astype(np.int32))
    eq2 = torch.from_numpy(rng.integers(0, 2, is_eq.shape).astype(bool))
    for ph, pp, eq in ((phys, p, is_eq), (phys2, p2, eq2)):
        vals, lane = select_extract(torch.from_numpy(tab), ph, pp, eq, t, tb)
        assert vals.dtype == torch.float32 and lane.dtype == torch.int32
        for b in range(tab.shape[0]):
            jv, jl = pallas_select_extract(jnp.asarray(tab[b]), jnp.asarray(ph[b].numpy()),
                                           jnp.asarray(pp[b].numpy()), jnp.asarray(eq[b].numpy()),
                                           jnp.asarray(int(t[b])), thr_bits=tb, interpret=True)
            np.testing.assert_array_equal(vals[b].numpy().view(np.int32), np.asarray(jv).view(np.int32))
            np.testing.assert_array_equal(lane[b].numpy(), np.asarray(jl))
    miss = (p2 < 0) | (p2 > 127)
    assert (vals[miss] == 0).all() and (lane[miss] == 0).all()


def test_select_extract_reference_equals_the_fetch_and_tail():
    tab = table(7, 60, "random")
    tb = thr_bits_of(0.25)
    t, off = offsets(tab, 400, tb)
    rows, phys, p, is_eq = lookup_fetch_reference(torch.from_numpy(tab), off, 400)
    vals, lane = select_extract_reference(torch.from_numpy(tab), phys, p, is_eq, t, tb)
    assert torch.equal(vals, torch.gather(rows, 2, lane.long()[..., None])[..., 0])
    assert (vals > 0.25).all()


@pytest.mark.parametrize("row_gather", ["pallas_lookup", "pallas_full"])
@pytest.mark.parametrize("case", CASES)
def test_select_topk_threshold_route_matches_jax(case, row_gather):
    n, k, thr = 160 * 128 - 37, 512, 0.005  # a partial last chunk
    flat = table(3, 160, case).reshape(2, -1)[:, :n]
    vals, idx = TS.select_topk_threshold(torch.from_numpy(flat), k, thr, row_gather=row_gather)
    base = TS.select_topk_threshold(torch.from_numpy(flat), k, thr)
    assert torch.equal(vals, base[0]) and torch.equal(idx, base[1])
    fn = jax.jit(lambda x: JS.select_topk_threshold(x, k, thr, row_gather=row_gather))
    for b in range(flat.shape[0]):
        jv, ji = fn(jnp.asarray(flat[b]))
        np.testing.assert_array_equal(vals[b].numpy().view(np.int32), np.asarray(jv).view(np.int32))
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ji))


def test_unknown_row_gather_raises():
    with pytest.raises(ValueError, match="row_gather"):
        TS.select_topk_threshold(torch.zeros(1, 256), 8, 0.1, row_gather="xla")
