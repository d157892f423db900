"""The kernel bounds against the bound column of PERF.md's kernel table
(section 6) at that table's shapes, batch 8, at the card's peaks."""

from __future__ import annotations

import pytest

from portbench.spec import Bounds


def _ms(bounds, op, launch, **kw):
    nbytes, ops, kind = bounds.of(op).work(launch, **kw)
    return 1e3 * bounds.least_seconds(nbytes, ops, kind)


@pytest.fixture
def bounds():
    return Bounds()


def test_every_serving_op_has_a_bound(bounds):
    for op in ("fused_cells_stage1", "bisect_count", "row_fetch", "lookup_fetch",
               "select_extract", "nms_mask"):
        assert hasattr(bounds.of(op), "work"), op
    assert bounds.of("no_such_op") is None


@pytest.mark.parametrize("dtype_bytes,want", [(4, 0.0414), (2, 0.0207)])
def test_fused_cells_stage1(bounds, dtype_bytes, want):
    levels = [[8, 80, 80, 255], [8, 40, 40, 255], [8, 20, 20, 255]]
    launch = {"shapes": [levels, [], []], "dtypes": ["TensorList"], "scalars": [None, 3, 85],
              "float_bytes": dtype_bytes}
    assert _ms(bounds, "fused_cells_stage1", launch) == pytest.approx(want, abs=5e-5)
    # a profiler that records no shapes for the list: the cell's levels
    launch_no_shapes = dict(launch, shapes=[[], [], []], levels=levels)
    assert _ms(bounds, "fused_cells_stage1", launch_no_shapes) == pytest.approx(want, abs=5e-5)


@pytest.mark.parametrize("rows,k,want", [(2565, 4096, 0.0032), (325, 512, 0.0004),
                                          (197, 4104, 0.0002), (12500, 20000, 0.0155)])
def test_bisect_count(bounds, rows, k, want):
    launch = {"shapes": [[8, rows, 128], [], []], "dtypes": ["float"], "scalars": [None, k, 0],
              "float_bytes": 4}
    assert _ms(bounds, "bisect_count", launch) == pytest.approx(want, abs=5e-5)


@pytest.mark.parametrize("k,pairs,bytes_,want", [(4096, 874483, 131072, 0.000157),
                                                 (512, 443804, 73728, 0.000079),
                                                 (16448, 874744, 328704, 0.000157)])
def test_nms_mask(bounds, k, pairs, bytes_, want):
    launch = {"shapes": [[8, k, 4], [8, k], [], [], []], "dtypes": ["float", "bool"],
              "scalars": [None, None, 0.45, 256, 300], "float_bytes": 4}
    assert bounds.of("nms_mask").work(launch)[0] == bytes_
    assert _ms(bounds, "nms_mask", launch, pairs=pairs) == pytest.approx(want, abs=2e-6)


@pytest.mark.parametrize("op,want_main", [("row_fetch", 0.00756), ("lookup_fetch", 0.00766),
                                          ("select_extract", 0.00268)])
def test_row_kernels(bounds, op, want_main):
    """(2565, 128) k=4096: from shapes alone every slot's row is taken as
    distinct (the most), which bounds the table's main-path figure from
    above; with the main path's distinct rows it matches it."""
    shapes = {"row_fetch": [[8, 2565, 128], [8, 4096]],
              "lookup_fetch": [[8, 2565, 128], [8, 5130]],
              "select_extract": [[8, 2565, 128], [8, 4096]]}[op]
    launch = {"shapes": shapes + [[]] * 4, "dtypes": ["float", "int"],
              "scalars": [None, None, 4096, None, None, None], "float_bytes": 4}
    assert _ms(bounds, op, launch) >= want_main
    # the distinct rows the main path touched, as the table's figure implies
    rows = {"row_fetch": 16290, "lookup_fetch": 16060, "select_extract": 16670}[op]
    assert _ms(bounds, op, launch, rows=rows) == pytest.approx(want_main, rel=0.02)
