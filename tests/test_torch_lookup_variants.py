"""The timing kernels of ``tools/experiments``: the lookup-fetch variants
and the row fetch at a swept launch geometry, port against its oracles.

Each plain version of ``lookup_fetch_variant`` against a numpy oracle
written from the TPU kernel body of
``tools/experiments/lookup_kernel_variants.py`` (``make_kernel``), bit
for bit, at the serving and eval chunk tables with random, tied and empty
tiers; ``'full'`` also against the Pallas ``pallas_lookup_fetch`` in
interpret mode.  ``row_fetch_p`` on CPU tensors is ``row_fetch_reference``
at every geometry; bad geometries and unknown variants raise; the timing
entry points import without running anything and refuse to run without a
GPU."""

import functools
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import yolort_tpu_torch
from yolort_tpu.ops.pallas.lookup_kernel import pallas_lookup_fetch
from yolort_tpu_torch.experiments import (
    fetch_block_sweep, fetch_place_compare, lookup_kernel_variants,
)
from yolort_tpu_torch.ops.cuda import (
    KERNELS, _build, bisect_count_reference, lookup_fetch_reference, lookup_fetch_variant,
    lookup_fetch_variant_reference, reset_launch_counts, row_fetch_p, row_fetch_reference,
)
from yolort_tpu_torch.ops.cuda.lookup_kernel import VARIANTS

SHAPES = [(325, 512, 0.25), (2565, 4096, 0.005)]  # (m, k, threshold): serving and eval tables
TIERS = ["random", "ties", "empty"]


@functools.lru_cache(maxsize=None)
def _inputs(m, k, thr, tier, batch=2):
    """(table (B, m, 128) f32, off (B, 2m) i32) as numpy: scores in [0, 1)
    and the exclusive tier offsets ``bisect_count`` gives for k."""
    rng = np.random.default_rng(m + k)
    n = m * 128
    if tier == "random":
        x = rng.uniform(0, 1, (batch, n))
    elif tier == "ties":  # few distinct values: boundary tie storms
        x = np.full((batch, n), 0.25)
        x[:, rng.integers(0, n, 300)] = 0.5
    else:  # nothing above the threshold: every offset 0
        x = np.zeros((batch, n))
    tab = x.astype(np.float32).reshape(batch, m, 128)
    _, cg, ce = bisect_count_reference(torch.from_numpy(tab), k, int(np.float32(thr).view(np.int32)))
    cnt = torch.cat([cg, ce], 1)
    return tab, (cnt.cumsum(1, dtype=torch.int32) - cnt).numpy()


def _oracle(tab, off, k, variant):
    """One image, as the TPU variant kernel computes it (W = 128 lanes):
    row maxima of the offsets padded with 2^30, the count of full rows,
    then the boundary loop over the rows it may end in."""
    lookup, boundary = variant != "fetch_only", variant in ("full", "no_fetch", "lookup_only")
    meta, fetch = variant in ("full", "no_boundary", "no_fetch"), variant in ("full", "no_boundary", "fetch_only")
    nc = tab.shape[0]
    m2 = 2 * nc
    offp = np.concatenate([off, np.full(-m2 % 128, 2**30, np.int32)]).reshape(-1, 128)
    rowmax = offp.max(1)
    s = np.arange(k)[:, None]
    if lookup:
        full = rowmax[None, :] <= s
        br = full.sum(1, keepdims=True)
        cnt = br * 128
        omax = np.where(full, rowmax[None, :], 0).max(1, keepdims=True)
        if boundary:
            for rb in range(offp.shape[0]):
                row = offp[rb][None, :]
                le = (row <= s) & (br == rb)
                cnt = cnt + le.sum(1, keepdims=True)
                omax = np.maximum(omax, np.where(le, row, 0).max(1, keepdims=True))
        c = np.clip(cnt - 1, 0, m2 - 1)
        is_eq = (c >= nc).astype(np.int32)
        phys = c - is_eq * nc
        p = s - omax
    else:
        phys = np.minimum(s // 2, nc - 1)
    rows = tab.view(np.int32)[phys[:, 0]] if fetch else np.broadcast_to(phys, (k, 128))
    return (rows, phys[:, 0], p[:, 0] if meta else None, is_eq[:, 0].astype(bool) if meta else None)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("m,k,thr", SHAPES)
def test_variant_reference_matches_the_tpu_oracle(m, k, thr, tier, variant):
    tab, off = _inputs(m, k, thr, tier)
    rows, phys, p, is_eq = lookup_fetch_variant(torch.from_numpy(tab), torch.from_numpy(off), k, variant)
    assert rows.shape == (2, k, 128) and rows.dtype == torch.float32 and phys.dtype == torch.int32
    for b in range(2):
        o_rows, o_phys, o_p, o_eq = _oracle(tab[b], off[b], k, variant)
        np.testing.assert_array_equal(rows[b].numpy().view(np.int32), o_rows)
        np.testing.assert_array_equal(phys[b].numpy(), o_phys)
        if o_p is None:
            assert p is None and is_eq is None
        else:
            assert p.dtype == torch.int32 and is_eq.dtype == torch.bool
            np.testing.assert_array_equal(p[b].numpy(), o_p)
            np.testing.assert_array_equal(is_eq[b].numpy(), o_eq)


@pytest.mark.parametrize("tier", TIERS)
def test_full_variant_matches_pallas_lookup_fetch(tier):
    m, k, thr = SHAPES[0]
    tab, off = _inputs(m, k, thr, tier)
    rows, phys, p, is_eq = lookup_fetch_variant(torch.from_numpy(tab), torch.from_numpy(off), k, "full")
    for b in range(2):
        jr, jphys, jp, jeq = pallas_lookup_fetch(jnp.asarray(tab[b]), jnp.asarray(off[b]), k, interpret=True)
        np.testing.assert_array_equal(rows[b].numpy().view(np.int32), np.asarray(jr).view(np.int32))
        np.testing.assert_array_equal(phys[b].numpy(), np.asarray(jphys))
        np.testing.assert_array_equal(p[b].numpy(), np.asarray(jp))
        np.testing.assert_array_equal(is_eq[b].numpy(), np.asarray(jeq))


def test_no_boundary_variant_lands_on_row_ends():
    """Offsets 0..2m-1 (one entry per chunk): the coarse search alone lands
    each slot on the last offset of the last whole row at or below it."""
    m = 200  # 400 offsets: three whole rows of 128 and a padded one
    tab = torch.arange(m * 128, dtype=torch.float32).reshape(1, m, 128)
    off = torch.arange(2 * m, dtype=torch.int32)[None]
    _, phys, p, is_eq = lookup_fetch_variant_reference(tab, off, 400, "no_boundary")
    s = torch.arange(400)
    rows_below = torch.div(s + 1, 128, rounding_mode="floor").clamp(max=3)
    c = (128 * rows_below - 1).clamp(min=0)
    assert torch.equal(phys[0].long(), torch.where(c >= m, c - m, c))
    assert torch.equal(is_eq[0], c >= m)
    assert torch.equal(p[0].long(), torch.where(rows_below > 0, s - c, s))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("w", [4, 128, 255])
def test_row_fetch_p_on_cpu_is_the_plain_version(w, dtype):
    reset_launch_counts()
    rng = np.random.default_rng(w)
    tab = torch.from_numpy(rng.standard_normal((2, 37, w)).astype(np.float32)).to(dtype)
    idx = torch.from_numpy(rng.integers(-3, 40, (2, 90)).astype(np.int32))
    iv = torch.int32 if dtype == torch.float32 else torch.int16
    want = row_fetch_reference(tab, idx).view(iv)
    for g in ((1, 1), (8, 1), (32, 8), (3, 5)):
        assert torch.equal(row_fetch_p(tab, idx, *g).view(iv), want)
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)
    assert not _build._loaded


@pytest.mark.parametrize("geometry", [(0, 1), (33, 1), (8, 0), (-1, 4)])
def test_row_fetch_p_bad_geometry_raises(geometry):
    tab, idx = torch.zeros(1, 4, 128), torch.zeros(1, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match="warps_per_block"):
        row_fetch_p(tab, idx, *geometry)
    with pytest.raises(ValueError, match="warps_per_block"):
        row_fetch_p(tab.to("meta"), idx.to("meta"), *geometry)


@pytest.mark.parametrize("variant", ["boundary_only", "", "FULL"])
def test_unknown_variant_raises(variant):
    tab, off = torch.zeros(1, 4, 128), torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="variant"):
        lookup_fetch_variant(tab, off, 5, variant)


def test_variant_wrapper_checks_its_inputs():
    tab, off = torch.zeros(1, 4, 128), torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="off"):
        lookup_fetch_variant(tab, off[:, :-1], 5, "full")
    with pytest.raises(ValueError, match="k must be"):
        lookup_fetch_variant(tab, off, 0, "no_fetch")
    with pytest.raises(ValueError, match="cuda or cpu"):
        lookup_fetch_variant(tab.to("meta"), off.to("meta"), 5, "fetch_only")


def test_importing_the_entry_points_runs_nothing():
    code = ("import torch\n"
            "import yolort_tpu_torch.experiments.fetch_block_sweep\n"
            "import yolort_tpu_torch.experiments.lookup_kernel_variants\n"
            "import yolort_tpu_torch.experiments.fetch_place_compare\n"
            "import yolort_tpu_torch.experiments.timing\n"
            "from yolort_tpu_torch.ops.cuda import KERNELS, _build\n"
            "assert not _build._loaded and not any(fn.launches for fn in KERNELS)\n"
            "assert not torch.cuda.is_initialized()\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                         cwd=Path(yolort_tpu_torch.__file__).parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout == "" and out.stderr == ""


@pytest.mark.parametrize("module", [lookup_kernel_variants, fetch_block_sweep, fetch_place_compare])
def test_entry_points_raise_without_a_gpu(module, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point would run")
    with pytest.raises(RuntimeError, match="CUDA device"):
        module.main(["--batch", "2"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("cfg", list(fetch_place_compare.STAGE2))
def test_compare_times_row_fetch_on_the_default_routes_indices(cfg):
    """fetch_place_compare's main-path indices are the phys that
    select_topk_threshold's default route hands row_fetch (the lookup's)."""
    m, k, thr = fetch_place_compare.STAGE2[cfg]
    tab = fetch_place_compare.score_table(1, 2, m, "cpu")
    t, cnt, off, thr_bits = fetch_place_compare.tiers(tab, k, thr)
    assert thr_bits == int(np.float32(thr).view(np.int32)) and cnt.shape == (2, 2 * m)
    _, phys, _, _ = lookup_fetch_reference(tab, off, k)
    assert torch.equal(fetch_place_compare.main_path_phys(off, k, m), phys)


def test_variant_inputs_are_the_tpu_scripts():
    tab, off = lookup_kernel_variants.make_inputs(3, "cpu", seed=1)
    assert tab.shape == (3, 2565, 128) and tab.dtype == torch.float32
    assert off.shape == (3, 5130) and off.dtype == torch.int32 and off.is_contiguous()
    cnt = torch.diff(off, dim=1)
    assert (off[:, 0] == 0).all() and (cnt[:, :2565] >= 0).all() and (cnt[:, :2565] <= 3).all()
    eq = torch.diff(off[:, 2564:], dim=1)  # the last gt count, then the eq counts
    assert (eq[:, 1:] <= 1).all() and int(eq[0, 1:].sum()) <= 4
    assert lookup_kernel_variants.check(tab[:1], off[:1], lookup_kernel_variants.K) == 0.0  # plain, plain


def test_sweep_inputs_are_the_tpu_scripts():
    shapes = fetch_block_sweep.make_inputs(1, "cpu", seed=2)
    assert set(shapes) == set(fetch_block_sweep.LABELS)
    (tab1, idx1), (tab2, idx2) = shapes["stage2"], shapes["cells"]
    assert tab1.shape == (1, 2565, 128) and tab1.dtype == torch.float32 and idx1.shape == (1, 4096)
    assert tab2.shape == (1, 8400, 255) and tab2.dtype == torch.bfloat16 and idx2.shape == (1, 4104)
    assert idx1.dtype == idx2.dtype == torch.int32
    assert (torch.diff(idx1) >= 0).all()
    runs = torch.diff(idx2) >= 0
    assert runs[:, :3499].all() and runs[:, 3500:].all()
    assert fetch_block_sweep.check(tab2, idx2, fetch_block_sweep.GEOMETRIES[:4]) == 0.0  # plain, plain


@pytest.mark.parametrize("counts,kernels_per_call,complete", [
    ({"k": 5}, 1, True),
    ({"k": 5}, None, True),
    ({"k": 3}, 1, False),  # two records of five lost: the window would read 40% low
    ({"k": 3}, None, False),
    ({"a": 10, "b": 5}, None, True),
    ({"a": 10, "b": 4}, None, False),
    ({"a": 5, "b": 5}, 1, False),  # a second kernel where one a call was expected
    ({}, None, False),  # the profiler saw no device time
])
def test_profiler_window_completeness(counts, kernels_per_call, complete):
    from yolort_tpu_torch.experiments.timing import window_complete

    assert window_complete(counts, 5, kernels_per_call) is complete


@pytest.mark.parametrize("records,kernels_per_call,usable,want_ms", [
    ({"k": (5, 50.0)}, 1, True, {"k": 0.010}),  # complete: total / calls
    ({"k": (4, 40.0)}, 1, True, {"k": 0.010}),  # one record lost: the mean does not read low
    ({"k": (3, 30.0)}, None, True, {"k": 0.010}),
    ({"a": (9, 90.0), "b": (5, 25.0)}, None, True, {"a": 0.020, "b": 0.005}),  # a twice a call
    ({"a": (5, 50.0), "b": (5, 5.0)}, 1, False, None),  # a second kernel where one was expected
    ({}, None, False, None),  # the profiler saw no device time
])
def test_profiler_lost_records_read_by_mean(records, kernels_per_call, usable, want_ms):
    from yolort_tpu_torch.experiments.timing import per_call, window_usable

    counts = {k: n for k, (n, _) in records.items()}
    assert window_usable(counts, 5, kernels_per_call) is usable
    if usable:
        got = per_call(records, 5)
        assert got.keys() == want_ms.keys()
        assert all(abs(got[k] - want_ms[k]) < 1e-12 for k in got)


@pytest.mark.parametrize("windows,kernels_per_call,want", [
    ([{"k": (5, 50.0)}], 1, 0.010),
    ([{}, {"k": (5, 50.0)}], 1, 0.010),  # an empty window is taken again
    ([{"k": (4, 40.0)}, {"k": (3, 33.0)}, {"k": (4, 44.0)}], 1, 0.010),  # the fullest, first
    ([{}, {}, {}], None, None),  # the profiler saw nothing: not measured
    ([{"a": (5, 50.0), "b": (5, 5.0)}] * 3, 1, RuntimeError),
])
def test_device_profile_windows(monkeypatch, windows, kernels_per_call, want):
    # torch.profiler replaced by one that yields the given windows' device
    # records {name: (count, total us)} over 5 calls, one window a profile
    from yolort_tpu_torch.experiments import timing

    class Event:
        device_type = "DeviceType.CUDA"

        def __init__(self, key, count, us):
            self.key, self.count, self.self_device_time_total = key, count, us

    left = iter(windows)

    class Profile:
        def __init__(self, **_):
            self.records = next(left)

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

        def step(self):
            pass

        def key_averages(self):
            return [Event(k, n, us) for k, (n, us) in self.records.items()]

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(timing, "PROFILE_PAD_S", 0.0)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="no usable window"):
            timing.device_profile(lambda: None, kernels_per_call=kernels_per_call)
        return
    total, rows = timing.device_profile(lambda: None, kernels_per_call=kernels_per_call)
    if want is None:
        assert total is None and rows == []
    else:
        assert abs(total - want) < 1e-12 and [k for k, _ in rows] == ["k"]
