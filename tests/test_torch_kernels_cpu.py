"""The port's kernel wrappers where there is no GPU: modules import without
nvcc, CPU tensors take the plain versions and launch nothing, any other
device raises, and a missing toolkit makes the build raise.

The kernel-against-plain cases carry the ``cuda`` marker and skip here;
on a machine with the card run them with
``python -m pytest tests/test_torch_kernels_cpu.py -m cuda``."""

import importlib.util
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import yolort_tpu_torch
from yolort_tpu_torch.ops.cuda import (
    KERNELS, _build, bias_act, bisect_count, bisect_count_reference, compact_place, compact_place_reference,
    fused_cells_stage1, fused_cells_stage1_reference, lookup_fetch, lookup_fetch_reference,
    lookup_fetch_variant, lookup_fetch_variant_reference, nms_mask, nms_mask_reference, qconv,
    qconv1x1, qconv1x1_reference, qconv_grouped, qconv_grouped_reference, qconv_kxk,
    qconv_kxk_reference, reset_launch_counts, row_fetch,
    row_fetch_p, row_fetch_reference, select_extract, select_extract_reference,
)
from yolort_tpu_torch.experiments.fetch_block_sweep import GEOMETRIES
from yolort_tpu_torch.ops.cuda.lookup_kernel import (
    BISECT_SMEM_BYTES, ROW_BYTES, VARIANTS, BisectPlan, _launch_bisect, bisect_plan,
    row_fetch_geometry,
)
from yolort_tpu_torch.ops.cuda.qconv_kernel import TILES, pack_weight, padded_depth, qconv_plan
from yolort_tpu_torch.ops.cuda.stage1_kernel import stage1_plan
from yolort_tpu_torch.ops.boxes import box_iou_matrix
from yolort_tpu_torch.ops.nms import NMSConfig, batched_postprocess_from_heads
from yolort_tpu_torch.ops.select import _chunk_table

PKG = Path(yolort_tpu_torch.__file__).parent


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(device="cpu"):
    rng = np.random.default_rng(0)
    cxy = rng.uniform(0, 200, (2, 512, 2))
    wh = rng.uniform(5, 80, (2, 512, 2))
    boxes = torch.from_numpy(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32)).to(device)
    valid = torch.arange(512, device=device)[None, :].expand(2, -1) < 400
    a = rng.standard_normal((2, 40 * 128)) * 2 - 1
    table = torch.from_numpy((1 / (1 + np.exp(-a))).astype(np.float32).reshape(2, 40, 128)).to(device)
    idx = torch.from_numpy(rng.integers(-3, 43, (2, 300)).astype(np.int32)).to(device)
    return boxes, valid.contiguous(), table, idx


def test_package_imports_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import|from)\s+(jax|yolort_tpu)\b")
    offenders = [f"{p}:{i}" for p in PKG.rglob("*.py")
                 for i, line in enumerate(p.read_text().splitlines(), 1) if pat.match(line)]
    assert not offenders
    code = ("import sys, yolort_tpu_torch; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'yolort_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=PKG.parent, timeout=120)


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    reset_launch_counts()
    boxes, valid, table, idx = _inputs()
    assert torch.equal(nms_mask(boxes, valid, 0.5, 256, 100), nms_mask_reference(boxes, valid, 0.5, 256, 100))
    for a, b in zip(bisect_count(table, 300, 0x3E800000), bisect_count_reference(table, 300, 0x3E800000)):
        assert torch.equal(a, b)
    assert torch.equal(row_fetch(table, idx), row_fetch_reference(table, idx))
    assert torch.equal(row_fetch_p(table, idx, 4, 2), row_fetch_reference(table, idx))
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)
    assert not _build._loaded  # nothing was built or loaded


def test_other_devices_raise():
    boxes, valid, table, idx = (t.to("meta") for t in _inputs())
    with pytest.raises(ValueError, match="cuda or cpu"):
        nms_mask(boxes, valid, 0.5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        bisect_count(table, 10, 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        row_fetch(table, idx)
    with pytest.raises(ValueError, match="cuda or cpu"):
        row_fetch_p(table, idx, 8, 1)


def test_wrappers_check_their_inputs():
    boxes, valid, table, idx = _inputs()
    with pytest.raises(ValueError):
        nms_mask(boxes.double(), valid, 0.5)
    with pytest.raises(ValueError):
        nms_mask(boxes, valid[:, :10], 0.5)
    with pytest.raises(ValueError):
        bisect_count(table[..., :64], 10, 0)
    with pytest.raises(ValueError):
        bisect_count(table, 0, 0)
    with pytest.raises(ValueError):
        bisect_count(table, 10, -1)
    with pytest.raises(ValueError):
        row_fetch(table.half(), idx)
    with pytest.raises(ValueError):
        row_fetch(table, idx[:1])


def test_build_names_library_by_source_hash(monkeypatch):
    path = _build.library_path()
    assert path.parent == PKG.parent / "build" / "yolort_tpu_torch"
    assert re.fullmatch(r"libyolort_kernels_[0-9a-f]{16}\.so", path.name)
    assert {p.name for p in (PKG / "csrc").glob("*.cu")} == set(_build.SOURCES)
    assert {p.name for p in (PKG / "csrc").glob("*.cuh")} == set(_build.HEADERS)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path() != path


def test_build_without_toolkit_raises(monkeypatch, tmp_path):
    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        _build.build()
    monkeypatch.setattr(ext, "CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def _nms_case(device, bsz, k, kind, seed=0):
    """Score-sorted, class-offset candidates, 70% valid: 'dense' boxes
    (5-200 px in a 640 px frame, many overlaps), 'sparse' ones (2-24 px:
    most are kept: the kept list takes many pages), 'invalid' (no valid
    candidate), 'overlap' (one box repeated, all valid) or 'inputs' (the
    module's ``_inputs`` boxes, 512 candidates of which 400 valid, two
    images)."""
    if kind == "inputs":
        return _inputs(device)[:2]
    rng = np.random.default_rng(seed + k)
    cxy = rng.uniform(0, 640, (bsz, k, 2))
    wh = rng.uniform(2, 24, (bsz, k, 2)) if kind == "sparse" else rng.uniform(5, 200, (bsz, k, 2))
    boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], -1)
    boxes += (rng.integers(0, 4, (bsz, k)) * 1000.0)[..., None]
    valid = np.arange(k)[None, :].repeat(bsz, 0) < int(k * 0.7)
    if kind == "invalid":
        valid[:] = False
    if kind == "overlap":
        boxes[:] = (10.0, 10.0, 50.0, 50.0)
        valid[:] = True
    return (torch.from_numpy(boxes.astype(np.float32)).to(device),
            torch.from_numpy(valid).to(device))


NMS_CASES = [  # (bsz, k, stop_after, tile, kind)
    *[(8, k, stop, tile, "dense") for k in (512, 4096) for stop in (0, 300) for tile in (128, 256)],
    *[(2, 16448, stop, tile, kind) for stop in (0, 300) for tile in (128, 256)
      for kind in ("dense", "sparse")],
    (8, 4096, 0, 256, "sparse"),      # a kept list of many pages
    (8, 4096, 1500, 256, "sparse"),   # a stop_after past one page
    (8, 4096, 300, 256, "sparse"),
    (8, 512, 300, 256, "invalid"),
    (8, 512, 0, 256, "overlap"),
    (3, 300, 0, 256, "dense"),        # K below the tile and not a multiple of it
    (3, 300, 10, 64, "dense"),
    (2, 512, 0, 256, "inputs"),       # at iou_thresh 0.5
    (2, 512, 100, 256, "inputs"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,k,stop,tile,kind", NMS_CASES)
def test_nms_mask_kernel_matches_plain(cuda_device, bsz, k, stop, tile, kind):
    boxes, valid = _nms_case(cuda_device, bsz, k, kind)
    thr = 0.5 if kind == "inputs" else 0.45
    got = nms_mask(boxes, valid, thr, tile, stop)
    want = nms_mask_reference(boxes, valid, thr, tile, stop)
    torch.cuda.synchronize()
    assert torch.equal(got, want)  # the whole mask, past the early exit too
    if kind == "overlap":
        assert int(got.sum()) == bsz


def _score_table(device, bsz, m, kind, seed=0):
    """(bsz, m, 128) sigmoid-product scores: 'random', 'ties' (40 levels),
    'fewer' (0.2% of the entries nonzero), 'none' (all below 0.025) or
    'dense' (each image's scores sorted descending and lifted into [0.5,
    1): every entry valid, the top k fill whole chunk rows); or 'inputs',
    the module's ``_inputs`` table (one sigmoid, (2, 40, 128))."""
    if kind == "inputs":
        return _inputs(device)[2]
    rng = np.random.default_rng(seed + m)
    a, c = rng.standard_normal((2, bsz, m * 128)) * 2.0 - 1.0
    s = (1 / (1 + np.exp(-a))) * (1 / (1 + np.exp(-c)))
    if kind == "ties":
        s = np.round(s * 40) / 40
    if kind == "fewer":
        s[:, int(m * 128 * 0.002):] = 0.0
    if kind == "none":
        s *= 0.025
    if kind == "dense":
        s = 0.5 + 0.5 * -np.sort(-s, axis=-1)
    return torch.from_numpy(s.astype(np.float32).reshape(bsz, m, 128)).to(device)


BISECT_CASES = [  # (bsz, m, k, thr, kind)
    (8, 197, 4104, 0.0, "random"),     # stage 1 at 640, eval
    (8, 197, 520, 0.0, "random"),      # stage 1 at 640, serving
    (1, 197, 4104, 0.0, "ties"),
    (8, 325, 512, 0.25, "random"),     # stage 2, serving
    (33, 325, 512, 0.25, "ties"),
    (8, 325, 512, 0.25, "fewer"),
    (33, 325, 512, 0.25, "none"),
    (8, 2565, 4096, 0.005, "random"),  # stage 2, eval
    (1, 2565, 4096, 0.005, "ties"),
    (33, 2565, 4096, 0.005, "random"),
    (8, 12500, 20000, 0.005, "random"),  # streamed: pre_nms_topk = 20000
    (1, 12500, 20000, 0.005, "ties"),
    (8, 12500, 20000, 0.25, "fewer"),
    (1, 479, 4104, 0.0, "random"),     # stage 1 of P6 on the 768x1280 canvas, eval
    (8, 479, 520, 0.0, "random"),      # ... serving
    (1, 797, 4104, 0.0, "ties"),       # stage 1 of P6 at 1280x1280, eval
    (8, 797, 4104, 0.0, "random"),
    (8, 797, 520, 0.0, "random"),      # ... serving
    (8, 5000, 8000, 0.005, "random"),  # streamed: past half an SM at 16 blocks
    (32, 7000, 11000, 0.005, "random"),
    (2, 40, 300, 0.25, "random"),
    (2, 40, 5000, 0.25, "random"),     # k beyond the entries
    (2, 40, 10, 0.9999, "random"),     # none valid
    (2, 3, 10, 0.25, "random"),        # fewer rows than a cluster's blocks
    (2, 40, 300, 0.25, "inputs"),
    (2, 40, 5000, 0.25, "inputs"),
    (2, 40, 10, 0.9999, "inputs"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,m,k,thr,kind", BISECT_CASES)
def test_bisect_count_kernel_matches_plain(cuda_device, bsz, m, k, thr, kind):
    table = _score_table(cuda_device, bsz, m, kind)
    bits = int(np.float32(thr).view(np.int32))
    got = bisect_count(table, k, bits)
    want = bisect_count_reference(table, k, bits)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("resident", [True, False])
def test_bisect_count_kernel_matches_plain_at_every_plan(cuda_device, cluster, resident):
    """Both modes at every cluster size give the plain version's result; a
    resident slice the card cannot hold is refused, not run, and only past
    bisect_plan's budget; a refusal leaves no error for the next launch."""
    for m, kind in ((2565, "random"), (197, "ties"), (479, "random"), (797, "random")):
        table = _score_table(cuda_device, 4, m, kind, seed=cluster)
        want = bisect_count_reference(table, 4096, 0x3BA3D70A)
        try:
            got = _launch_bisect(table, 4096, 0x3BA3D70A, BisectPlan(cluster, resident))
        except RuntimeError as e:
            assert "bisect_count" in str(e) and resident
            assert -(-m // cluster) * ROW_BYTES > BISECT_SMEM_BYTES
            got = bisect_count(table, 4096, 0x3BA3D70A)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("bsz,m,cluster,resident", [
    (8, 197, 8, True), (1, 197, 8, True), (16, 197, 8, True), (32, 197, 8, True),
    (8, 325, 8, True), (32, 325, 8, True),
    (1, 2565, 16, True), (8, 2565, 16, True), (9, 2565, 16, True),
    (32, 2565, 16, True), (33, 2565, 16, True),
    (1, 12500, 16, False), (8, 12500, 16, False), (32, 12500, 16, False),  # too large a slice
    (1, 5000, 16, False), (32, 7000, 16, False), (32, 7200, 16, False),  # past half an SM
    (8, 3200, 16, True), (8, 3201, 16, False),  # 200 rows a block fit, 201 do not
    (1, 479, 8, True), (8, 479, 8, True), (1, 797, 16, True), (8, 797, 16, True),  # P6 stage 1
    (1, 1, 2, True), (4, 3, 3, True), (2, 40, 8, True), (65535, 197, 8, True),
])
def test_bisect_plan(bsz, m, cluster, resident):
    plan = bisect_plan(bsz, m)
    assert plan == (cluster, resident)
    assert 2 <= plan.cluster <= 16
    rows = -(-m // plan.cluster)
    # a valid launch: every row has a block; two resident blocks, each with
    # its rows, the kernel's static part (under 4 KB) and the runtime's 1 KB,
    # share an H100 SM's 228 KB, so a 16-block cluster needs 8 SMs
    assert rows * plan.cluster >= m
    assert plan.resident == (rows * ROW_BYTES <= BISECT_SMEM_BYTES)
    if plan.resident:
        assert 2 * (rows * 512 + 4096 + 1024) <= 228 * 1024


def test_bisect_plan_refuses_an_empty_table_and_a_grid_past_its_limit():
    for bsz, m in ((0, 10), (8, 0), (65536, 197)):
        with pytest.raises(ValueError):
            bisect_plan(bsz, m)


def _greedy_work(boxes, valid, thr, tile, stop):
    """Sequential greedy NMS with the early exit, one candidate at a time:
    (keep (B, K) bool, exit per image, IoU pairs tested)."""
    bsz, k, _ = boxes.shape
    iou = box_iou_matrix(boxes, boxes) > torch.tensor(thr, dtype=torch.float32)
    keep = valid.clone()
    exits, pairs = [], 0
    for b in range(bsz):
        kept = []
        exit_at = k
        for i in range(k):
            if i and i % tile == 0 and stop > 0 and len(kept) >= stop:
                exit_at = i
                break
            if valid[b, i]:
                pairs += len(kept)
                keep[b, i] = not any(iou[b, i, j] for j in kept)
                if keep[b, i]:
                    kept.append(i)
        exits.append(exit_at)
    return keep, exits, pairs


@pytest.mark.parametrize("k,tile,stop", [
    (96, 16, 5), (96, 16, 12), (100, 32, 20), (100, 64, 1), (96, 16, 0),
])
def test_chip_smoke_nms_work_counts_what_greedy_nms_needs(k, tile, stop):
    """The smoke's nms_mask bound counts the IoU pairs and box bytes that
    greedy NMS reads up to the early exit, checked by a sequential walk
    (the exits fall in the first, a middle and no tile)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", PKG.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    rng = np.random.default_rng(tile + stop)
    cxy = rng.uniform(0, 100, (3, k, 2))
    wh = rng.uniform(20, 60, (3, k, 2))  # crowded: many suppressions, later exits
    boxes = torch.from_numpy(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1).astype(np.float32))
    valid = torch.from_numpy(rng.uniform(size=(3, k)) < 0.8)
    keep, exits, pairs = _greedy_work(boxes, valid, 0.3, tile, stop)
    ref = nms_mask_reference(boxes, valid, 0.3, tile, stop)
    assert torch.equal(ref, keep)
    assert smoke.nms_work(ref, valid, tile, stop) == (16 * sum(exits) + 2 * 3 * k, pairs)


def test_chip_smoke_int8_witness_and_flip_spread():
    """The smoke's conv-by-conv int8 comparison, run with the CPU on both
    sides: every quantized conv and residual add in call order, nothing
    parts, and the exact epilogue rounds to the plain version's int8 but
    at values an ulp from a rounding boundary; one flip of one level is
    seen at its own conv as one value, and spreads downstream."""
    from yolort_tpu_torch.ops import quantization as Q

    spec = importlib.util.spec_from_file_location("chip_smoke", PKG.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    m = yolort_tpu_torch.yolov5n6(device="cpu", seed=0, size=(128, 128))
    x = torch.from_numpy(np.random.default_rng(0).random((2, 128, 128, 3), dtype=np.float32))
    Q.calibrate_activations(m.model, [x])
    q = Q.finalize_scales(Q.quantize_compute_params(m.model), x[:1])
    calls = smoke.int8_calls(q, x[:1])
    convs = [c for c in calls if hasattr(c[1], "wq")]
    assert len(convs) == sum(getattr(mod, "quantized", False) for mod in q.modules())
    assert [c[0] for c in calls][-4:] == ["head.0", "head.1", "head.2", "head.3"]
    wit = smoke.int8_witness(q, x[:1], "cpu")
    assert wit["first"] is None and all(n == 0 for _, n, _, _ in wit["chained"])
    assert len(wit["forced"]) == len(convs)
    values = sum(total for _, _, total, _, n_card, _ in wit["forced"] if n_card is not None)
    assert sum(n_card or 0 for *_, n_card, _ in wit["forced"]) < 1e-4 * values
    spread = smoke.flip_spread(q, x[:1], "backbone.1")
    assert spread[0][:2] == ("backbone.1", 1) and spread[0][3] == 1.0
    assert sum(n for _, n, _, _ in spread[1:]) > 0


@pytest.mark.cuda
def test_vector_load_kernels_reject_misaligned_tensors(cuda_device):
    boxes, valid, table, _ = _inputs(cuda_device)
    # contiguous views that start one float past a 16-byte boundary
    shifted_boxes = boxes.flatten()[1:1 + 2 * 511 * 4].view(2, 511, 4)
    assert shifted_boxes.is_contiguous()
    with pytest.raises(ValueError, match="aligned"):
        nms_mask(shifted_boxes, valid[:, :511].contiguous(), 0.5)
    shifted_table = table.flatten()[1:1 + 128].view(1, 1, 128)
    with pytest.raises(ValueError, match="aligned"):
        bisect_count(shifted_table, 10, 0)


# row_fetch's cases: (dtype, width) pairs whose rows are 512 (the stage-2
# table), 508, 16 and 4 bytes in float32 and 510 (the cells table), 170,
# 256 and 2 bytes in bfloat16; k from 1 to 4104; and the index kinds
ROW_WIDTHS = [(torch.float32, 128), (torch.float32, 127), (torch.float32, 4), (torch.float32, 1),
              (torch.bfloat16, 255), (torch.bfloat16, 85), (torch.bfloat16, 128),
              (torch.bfloat16, 1)]
ROW_KS = [1, 31, 33, 512, 4104]
ROW_INDEX_KINDS = ("random", "sorted", "repeated", "out_of_range")
# every geometry row_fetch_geometry returns for those widths, at batch 1 to
# 128 and those k
FETCH_GEOMETRIES = sorted({row_fetch_geometry(w * dt.itemsize, bsz, k) for dt, w in ROW_WIDTHS
                           for bsz in (1, 2, 8, 32, 128) for k in ROW_KS})


def _row_index(kind, bsz, m, k, seed):
    """(bsz, k) int32 row indices: 'random' in [-5, m + 5); 'sorted', two
    index-ordered runs as stage 2's phys (with repeats, and out-of-range
    ends); 'repeated', every index four times in a row; 'out_of_range',
    each below 0 or at least m."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        idx = rng.integers(-5, m + 5, (bsz, k))
    elif kind == "sorted":
        cut = k * 3 // 4
        idx = np.concatenate([np.sort(rng.integers(-2, m + 2, (bsz, cut)), 1),
                              np.sort(rng.integers(0, m, (bsz, k - cut)), 1)], 1)
    elif kind == "repeated":
        idx = np.repeat(rng.integers(0, m, (bsz, -(-k // 4))), 4, axis=1)[:, :k]
    else:
        idx = np.where(rng.random((bsz, k)) < 0.5, rng.integers(-100, 0, (bsz, k)),
                       rng.integers(m, m + 100, (bsz, k)))
    return torch.from_numpy(idx.astype(np.int32))


def _row_cases(device, bsz=2, m=300):
    """(table, idx) for every width, k and index kind of the row cases: a
    table with sign / exponent corners and a NaN payload in each image."""
    rng = np.random.default_rng(11)
    for dt, w in ROW_WIDTHS:
        tab = torch.from_numpy(rng.standard_normal((bsz, m, w)).astype(np.float32)).to(dt)
        bits = tab.view(torch.int32 if dt == torch.float32 else torch.int16)
        bits[:, 3, w - 1] = 0x7FC00123 if dt == torch.float32 else 0x7FC1  # NaN payload
        bits[:, 4, 0] = -(2**31) if dt == torch.float32 else -(2**15)     # -0.0
        tab = tab.to(device)
        for k in ROW_KS:
            for n, kind in enumerate(ROW_INDEX_KINDS):
                yield tab, _row_index(kind, bsz, m, k, seed=k + n).to(device)


def _poisoned(monkeypatch, call):
    """``call()`` with every ``torch.empty`` it makes filled with all-ones
    bytes first (NaN as a float, -1 as an int), so that an output slot the
    kernel skips shows."""
    empty = torch.empty

    def poisoned_empty(*args, **kwargs):
        x = empty(*args, **kwargs)
        x.untyped_storage().fill_(255)  # any layout, channels_last too
        return x

    with monkeypatch.context() as mp:
        mp.setattr(torch, "empty", poisoned_empty)
        return call()


def test_row_fetch_geometry_follows_the_row_width_and_the_grid():
    assert row_fetch_geometry(512, 8, 512) == (4, 4)     # stage 2, serving
    assert row_fetch_geometry(512, 8, 4096) == (4, 4)    # stage 2, eval
    assert row_fetch_geometry(512, 128, 4096) == (4, 4)  # the sweep's batch
    assert row_fetch_geometry(512, 1, 512) == (4, 2)     # batch 1 serving: 512 slots
    assert row_fetch_geometry(510, 8, 4104) == (4, 2)    # the cells table: 2-byte words
    assert row_fetch_geometry(508, 8, 4096) == (4, 2)    # 4-byte words
    assert row_fetch_geometry(2048, 8, 4096) == (4, 4)
    assert FETCH_GEOMETRIES == [(4, 2), (4, 4)]


@pytest.mark.cuda
def test_row_fetch_kernel_matches_plain(cuda_device, monkeypatch):
    """At its own geometry, every width, k and index kind, its output
    blocks poisoned first."""
    _, _, table, idx = _inputs(cuda_device)
    for tab in (table, table.to(torch.bfloat16), table[..., :85].contiguous().to(torch.bfloat16)):
        iv = torch.int32 if tab.dtype == torch.float32 else torch.int16
        assert torch.equal(row_fetch(tab, idx).view(iv), row_fetch_reference(tab, idx).view(iv))
    for tab, idx in _row_cases(cuda_device):
        iv = torch.int32 if tab.dtype == torch.float32 else torch.int16
        got = _poisoned(monkeypatch, lambda: row_fetch(tab, idx))
        assert torch.equal(got.view(iv), row_fetch_reference(tab, idx).view(iv))


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", FETCH_GEOMETRIES)
def test_row_fetch_kernel_matches_plain_at_every_geometry(cuda_device, geometry):
    for tab, idx in _row_cases(cuda_device):
        iv = torch.int32 if tab.dtype == torch.float32 else torch.int16
        want = row_fetch_reference(tab, idx).view(iv)
        assert torch.equal(row_fetch_p(tab, idx, *geometry).view(iv), want)


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_row_fetch_p_kernel_matches_plain(cuda_device, geometry):
    _, _, table, idx = _inputs(cuda_device)
    for tab in (table, table[..., :4].contiguous(), table[..., :85].contiguous().to(torch.bfloat16),
                torch.cat([table, table[..., :127]], -1).to(torch.bfloat16)):
        iv = torch.int32 if tab.dtype == torch.float32 else torch.int16
        want = row_fetch_reference(tab, idx).view(iv)
        assert torch.equal(row_fetch_p(tab, idx, *geometry).view(iv), want)
        for kind in ROW_INDEX_KINDS[1:]:  # sorted, repeated and out-of-range runs
            sidx = _row_index(kind, 2, tab.shape[1], 700, seed=geometry[0]).to(cuda_device)
            want = row_fetch_reference(tab, sidx).view(iv)
            assert torch.equal(row_fetch_p(tab, sidx, *geometry).view(iv), want)


# compact_place's cases: name -> (chunks m, k); the scores come from
# compact_scores.  Shared with tests/test_torch_compact.py, which holds
# their plain version against the JAX kernel
COMPACT_CASES = {
    "all-gt chunk": (40, 300),   # one chunk's 128 entries all strictly above the k-th value
    "gt and eq": (40, 60),       # one chunk holding both tiers; the eq tier straddles k
    "ties straddle k": (40, 500),  # 20 levels: the eq tier runs past k across chunks
    "tail": (40, 512),           # fewer valid entries than k: the empty tail
    "none valid": (40, 512),
    "m=1": (1, 50),
    "m=33": (33, 700),           # a warp's run of 32 chunks plus one
}
COMPACT_THRESH = 0.25


def compact_scores(name, bsz, seed=0):
    """(bsz, m * 128) float32 scores of a ``COMPACT_CASES`` case, at the
    threshold ``COMPACT_THRESH``."""
    m, _ = COMPACT_CASES[name]
    rng = np.random.default_rng([seed, m, len(name)])
    n = m * 128
    x = rng.random((bsz, n), dtype=np.float32)
    if name == "all-gt chunk":
        x *= 0.3
        for b, c in enumerate(rng.integers(0, m, bsz)):
            x[b, c * 128:(c + 1) * 128] = 0.9 + 0.05 * rng.random(128, dtype=np.float32)
    elif name == "gt and eq":
        x *= 0.2
        for b in range(bsz):
            c, c2 = rng.choice(m, 2, replace=False)
            x[b, c * 128:c * 128 + 20] = 0.9
            x[b, c * 128 + 20:c * 128 + 80] = 0.5
            x[b, c2 * 128:c2 * 128 + 40] = 0.5
            x[b, c2 * 128 + 40:c2 * 128 + 50] = 0.8
    elif name == "ties straddle k":
        x = np.round(x * 20) / 20
    elif name == "tail":
        x *= 0.2
        for b in range(bsz):
            x[b, rng.choice(n, 30 + b % 7, replace=False)] = 0.3 + 0.7 * rng.random(30 + b % 7)
    elif name == "none valid":
        x *= COMPACT_THRESH
    return x.astype(np.float32)


def _compact_inputs(name, bsz, device):
    """(table, cnt, off, t, thr_bits, k) of a COMPACT_CASES case: the
    tier counts and k-th value bits from bisect_count's plain version."""
    _, k = COMPACT_CASES[name]
    table = _chunk_table(torch.from_numpy(compact_scores(name, bsz))).to(device)
    thr_bits = int(np.float32(COMPACT_THRESH).view(np.int32))
    t, cg, ce = bisect_count_reference(table, k, thr_bits)
    cnt = torch.cat([cg, ce], 1).contiguous()
    off = (cnt.cumsum(1, dtype=torch.int32) - cnt).contiguous()
    return table, cnt, off, t, thr_bits, k


@pytest.mark.cuda
@pytest.mark.parametrize("bsz", [1, 8, 32])
@pytest.mark.parametrize("name", list(COMPACT_CASES))
def test_compact_place_kernel_matches_plain(cuda_device, monkeypatch, name, bsz):
    """Bit for bit, every slot written: the outputs' blocks are poisoned
    (NaN, -1) before the call; one launch a call."""
    table, cnt, off, t, thr_bits, k = _compact_inputs(name, bsz, cuda_device)
    want = compact_place_reference(table, cnt, off, t, thr_bits, k)
    before = compact_place.launches
    got = _poisoned(monkeypatch, lambda: compact_place(table, cnt, off, t, thr_bits, k))
    torch.cuda.synchronize()
    assert compact_place.launches == before + 1
    for a, b in zip(got, want):
        assert _same_bits(a, b)


def _qconv_operands(k, n, h, w, c, co, seed, device="cpu", extreme=False, groups=1):
    """Seeded int8 activations (channels_last), packed int8 weights, f32
    scale and bias.  ``extreme``: activations +127 and weights +127 or -127
    by output channel, so |acc| reaches K * 127^2 inside the image."""
    rng = np.random.default_rng(seed)
    xq = torch.from_numpy(rng.integers(-127, 128, (n, h, w, c), dtype=np.int8))
    wq = rng.integers(-10, 11, (k, k, c // groups, co), dtype=np.int8)
    if extreme:
        xq.fill_(127)
        wq[...] = 127
        wq[..., 1::2] = -127
    wq = pack_weight(wq)
    scale = torch.from_numpy(rng.uniform(1e-7, 1e-6, (co,)).astype(np.float32)
                             if extreme else rng.uniform(1e-4, 1e-3, (co,)).astype(np.float32))
    bias = torch.from_numpy(rng.uniform(-1, 1, (co,)).astype(np.float32))
    xq = xq.permute(0, 3, 1, 2)  # NHWC bytes seen as channels_last NCHW
    return tuple(t.to(device) for t in (xq, wq, scale, bias))


def test_pack_weight_layout():
    wq = np.random.default_rng(0).integers(-127, 128, (6, 6, 3, 5), dtype=np.int8)
    packed = pack_weight(wq)
    assert packed.shape == (5, padded_depth(6, 3)) == (5, 108)
    np.testing.assert_array_equal(packed.numpy()[2, :3], wq[0, 0, :, 2])
    np.testing.assert_array_equal(packed.numpy()[2, 3:6], wq[0, 1, :, 2])
    odd = pack_weight(wq[:3, :3, :, :])  # K = 27 -> padded to 28 with a zero
    assert odd.shape == (5, 28) and (odd[:, 27] == 0).all()


def test_qconv_cpu_tensors_take_the_plain_versions():
    reset_launch_counts()
    xq, wq, scale, bias = _qconv_operands(3, 1, 8, 10, 16, 32, seed=1)
    for fn, ref, kw in ((qconv1x1, qconv1x1_reference, {}),
                        (qconv_kxk, qconv_kxk_reference, dict(k=3))):
        w = wq[:, :16].contiguous() if fn is qconv1x1 else wq
        got = fn(xq, w, scale, bias, inv_out_scale=4.0, **kw)
        assert torch.equal(got, ref(xq, w, scale, bias, inv_out_scale=4.0, **kw))
    args = _qconv_operands(5, 1, 8, 10, 16, 32, seed=3, groups=16)
    got = qconv_grouped(*args, k=5, stride=2, groups=16, act="relu", inv_out_scale=4.0)
    assert torch.equal(got, qconv_grouped_reference(*args, k=5, stride=2, groups=16, act="relu",
                                                    inv_out_scale=4.0))
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)
    assert not _build._loaded


def test_qconv_wrappers_check_their_inputs_and_refuse_groups():
    """Each wrapper raises on what its kernel does not take; a grouped conv
    needs weights packed for its groups and groups dividing both widths."""
    xq, wq, scale, bias = _qconv_operands(3, 1, 8, 10, 16, 32, seed=2)
    with pytest.raises(ValueError, match="groups"):
        qconv(xq, wq, scale, bias, k=3, groups=2)
    with pytest.raises(ValueError, match="groups=3 must divide"):
        qconv_grouped(xq, wq, scale, bias, k=3, groups=3)
    with pytest.raises(ValueError, match="wq"):
        qconv_kxk(xq, wq[:, :-4], scale, bias, k=3)
    with pytest.raises(ValueError, match="int8"):
        qconv_kxk(xq.float(), wq, scale, bias, k=3)
    with pytest.raises(ValueError, match="scale"):
        qconv_kxk(xq, wq, scale.double(), bias, k=3)
    with pytest.raises(ValueError, match="act"):
        qconv_kxk(xq, wq, scale, bias, k=3, act="gelu")
    with pytest.raises(ValueError, match="out_dtype"):
        qconv_kxk(xq, wq, scale, bias, k=3, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="cuda or cpu"):
        qconv_kxk(*(t.to("meta") for t in (xq, wq, scale, bias)), k=3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        qconv1x1(*(t.to("meta") for t in (xq, wq[:, :16].contiguous(), scale, bias)))


@pytest.mark.parametrize("m,cout,k,cin", [
    (4 * 640 * 640, 32, 6, 3),     # the yolov5s6 stem at 1280, batch 4
    (4 * 40 * 40, 384, 3, 256),    # the backbone's Cout 384 downsample
    (4 * 40 * 40, 384, 1, 768),    # a PAN C3's Cin 768
    (4 * 20 * 20, 512, 3, 384),    # the p6 downsample
    (4 * 20 * 20, 384, 1, 512),
    (2 * 40 * 40, 768, 3, 512),    # yolov5l6's Cout 768
])
def test_qconv_plan_covers_the_p6_shapes(m, cout, k, cin):
    """The tile and loader qconv_plan picks at the P6 shapes: a tile of the
    kernel's, output tiles that cover every pixel and channel, the
    cp.async loader for 16-channel rows, a ring that fits the card's
    shared memory."""
    plan = qconv_plan(m, cout, k * k * cin, cin, padded_depth(k, cin))
    assert (plan.bm, plan.bn) in TILES or (plan.bm, plan.bn) == (128, 32)
    assert plan.tiles[0] * plan.bm >= m and plan.tiles[1] * plan.bn >= cout
    assert plan.gather == (cin % 16 != 0) and plan.smem <= 232_448
    assert plan.slabs * 64 >= k * k * cin


QCONV_CASES = [
    (6, 2, 2, 2, 64, 96, 3, 32, "random"),
    (3, 2, 1, 2, 40, 48, 32, 64, "random"),
    (3, 1, 1, 2, 20, 24, 64, 64, "random"),
    (1, 1, 0, 2, 20, 24, 128, 96, "random"),
    (1, 1, 0, 1, 7, 9, 36, 255, "random"),
    # the regimes of the tensor-core kernel: M not a multiple of the tile
    (3, 1, 1, 1, 7, 9, 32, 64, "random"),
    (1, 1, 0, 3, 13, 11, 64, 128, "random"),
    # Cout 255 (element stores) and a Cout that is not a multiple of 8
    (1, 1, 0, 2, 10, 12, 64, 255, "random"),
    (3, 1, 1, 1, 9, 11, 32, 37, "random"),
    # K tails through the gather loader: the stem's C = 3, k = 6 (K = 108),
    # and C = 36
    (6, 2, 2, 1, 30, 34, 3, 32, "random"),
    (3, 1, 1, 2, 12, 10, 36, 64, "random"),
    # the extreme accumulator, +-127 at K = 2304
    (3, 1, 1, 2, 8, 8, 256, 64, "extreme"),
    (1, 1, 0, 2, 8, 8, 2304, 64, "extreme"),
    # stride-2 halos at a 1x1 and a 2x3 image
    (3, 2, 1, 1, 1, 1, 32, 32, "random"),
    (3, 2, 1, 2, 2, 3, 64, 64, "random"),
    # a 20x20 batch-8 layer, which takes a 64-row tile
    (3, 1, 1, 8, 20, 20, 256, 256, "random"),
    # yolov5s6 at 1280, batch 4: the stem, Cout 384 and Cin 768; Cout 768 (l6)
    (6, 2, 2, 4, 1280, 1280, 3, 32, "random"),
    (3, 2, 1, 4, 80, 80, 256, 384, "random"),
    (1, 1, 0, 4, 40, 40, 384, 192, "random"),
    (1, 1, 0, 4, 40, 40, 768, 384, "random"),
    (3, 2, 1, 4, 40, 40, 384, 512, "random"),
    (1, 1, 0, 4, 20, 20, 512, 384, "random"),
    (3, 2, 1, 2, 80, 80, 512, 768, "random"),
    (1, 1, 0, 2, 40, 40, 768, 768, "random"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("k,s,pad,n,h,w,c,co,fill", QCONV_CASES)
def test_qconv_kernels_match_plain(cuda_device, k, s, pad, n, h, w, c, co, fill):
    args = _qconv_operands(k, n, h, w, c, co, seed=k + c, device=cuda_device,
                           extreme=fill == "extreme")
    if (n, h, w) == (8, 20, 20):
        assert qconv_plan(8 * 20 * 20, co, k * k * c, c, padded_depth(k, c)).bm == 64
    for act in ("silu", "none"):
        kw = dict(k=k, stride=s, pad=pad, act=act)
        want = qconv_kxk_reference(*args, inv_out_scale=6.0, **kw)
        got = qconv(*args, inv_out_scale=6.0, **kw)
        assert torch.equal(got, want)
        for dt in (torch.float32, torch.bfloat16):
            wantf = qconv_kxk_reference(*args, out_dtype=dt, **kw)
            gotf = qconv(*args, out_dtype=dt, **kw)
            assert gotf.dtype == dt and torch.equal(gotf, wantf)


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["hardswish", "leaky_relu"])
@pytest.mark.parametrize("k,s,pad,n,h,w,c,co,fill", QCONV_CASES)
def test_qconv_kernels_match_plain_hardswish_and_leaky_relu(cuda_device, k, s, pad, n, h, w, c,
                                                            co, fill, act):
    """The epilogue's other activations (r3.1's Hardswish, LeakyReLU(0.1))
    at every shape of the SiLU cases, int8, float32 and bfloat16 out; the
    bias is shifted so y spans both Hardswish knees and both signs."""
    xq, wq, scale, bias = _qconv_operands(k, n, h, w, c, co, seed=k + c + 1, device=cuda_device,
                                          extreme=fill == "extreme")
    bias = bias * 4.0
    kw = dict(k=k, stride=s, pad=pad, act=act)
    for inv, dt in ((6.0, torch.float32), (None, torch.float32), (None, torch.bfloat16)):
        want = qconv_kxk_reference(xq, wq, scale, bias, inv_out_scale=inv, out_dtype=dt, **kw)
        got = qconv(xq, wq, scale, bias, inv_out_scale=inv, out_dtype=dt, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("k,s,pad,n,h,w,c,co", [
    (1, 1, 0, 8, 20, 20, 16, 72),     # yolo_lite's ReLU expand convs
    (1, 1, 0, 8, 40, 40, 24, 88),
    (3, 1, 1, 2, 12, 10, 36, 64),     # the gather loader
    (3, 2, 1, 2, 40, 48, 32, 64),
])
def test_qconv_kernels_match_plain_relu(cuda_device, k, s, pad, n, h, w, c, co):
    """The ReLU epilogue on the tensor-core kernel, int8, float32 and
    bfloat16 out, the bias spread across zero."""
    xq, wq, scale, bias = _qconv_operands(k, n, h, w, c, co, seed=k + c + 2, device=cuda_device)
    bias = bias * 3.0
    for inv, dt in ((6.0, torch.float32), (None, torch.float32), (None, torch.bfloat16)):
        kw = dict(k=k, stride=s, pad=pad, act="relu", inv_out_scale=inv, out_dtype=dt)
        want = qconv_kxk_reference(xq, wq, scale, bias, **kw)
        got = qconv(xq, wq, scale, bias, **kw)
        assert got.dtype == want.dtype and torch.equal(got, want)
        assert (want == 0).any() and (want > 0).any()


GROUPED_CASES = [
    # yolo_lite's depth-wise convs @640 (channels, input side, k, stride)
    (16, 16, 16, 2, 320, 320, 3, 2),
    (72, 72, 72, 2, 160, 160, 3, 2),
    (88, 88, 88, 2, 80, 80, 3, 1),
    (96, 96, 96, 2, 80, 80, 5, 2),
    (240, 240, 240, 2, 40, 40, 5, 1),
    (576, 576, 576, 2, 20, 20, 5, 1),
    # DWConv(96, 64, 5): G 32, C/G 3, Cout/G 2; C/G 4 and 8 (__dp4a)
    (96, 64, 32, 2, 20, 24, 5, 1),
    (16, 24, 4, 2, 13, 11, 3, 2),
    (32, 16, 4, 2, 9, 12, 5, 1),
    # a C3Ghost's cheap halves (C/G 1), a ragged Cout and one channel
    (8, 8, 8, 2, 40, 40, 5, 1),
    (6, 6, 6, 1, 9, 7, 3, 1),
    (12, 6, 3, 1, 7, 9, 3, 2),
    (1, 1, 1, 1, 5, 5, 3, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("c,co,g,n,h,w,k,s", GROUPED_CASES)
def test_qconv_grouped_kernel_matches_plain(cuda_device, monkeypatch, c, co, g, n, h, w, k, s):
    """qconv_grouped against its plain version, every activation, int8,
    float32 and bfloat16 out, outputs poisoned first."""
    xq, wq, scale, bias = _qconv_operands(k, n, h, w, c, co, seed=c + g + k, device=cuda_device,
                                          groups=g)
    bias = bias * 3.0
    for act in ("relu", "hardswish", "silu", "leaky_relu", "none"):
        for inv, dt in ((6.0, torch.float32), (None, torch.float32), (None, torch.bfloat16)):
            kw = dict(k=k, stride=s, groups=g, act=act, inv_out_scale=inv, out_dtype=dt)
            want = qconv_grouped_reference(xq, wq, scale, bias, **kw)
            got = _poisoned(monkeypatch, lambda: qconv(xq, wq, scale, bias, **kw))
            assert got.dtype == want.dtype and torch.equal(got, want), (act, inv, dt)


def _postprocess_inputs(device="cpu", dtype=torch.float32):
    """Head levels (NHWC, C = 255, one NaN / inf / sub-floor logit), and a
    stage-2 chunk table with its k-th value, tier counts and offsets."""
    rng = np.random.default_rng(3)
    heads = [torch.from_numpy((rng.standard_normal((2, h, w, 255)) * 3).astype(np.float32))
             for h, w in ((8, 10), (4, 5), (2, 3))]
    heads[0][0, 1, 2, 4] = float("nan")
    heads[0][1, 0, 0, 90] = float("inf")
    heads[1][0, 0, 1, 5:85] = -2e4
    heads = [h.to(device, dtype) for h in heads]
    _, _, table, _ = _inputs(device)
    thr = int(np.float32(0.25).view(np.int32))
    t, cg, ce = bisect_count_reference(table, 700, thr)
    cnt = torch.cat([cg, ce], 1)
    off = (cnt.cumsum(1, dtype=torch.int32) - cnt).contiguous()
    return heads, table, thr, t, cnt, off


def _same_bits(a, b):
    """Equal bit patterns, NaN positions compared as NaN (the card's amax
    need not keep a NaN's payload)."""
    if a.dtype.is_floating_point:
        iv = torch.int32 if a.element_size() == 4 else torch.int16
        nan = torch.isnan(a)
        return (a.shape == b.shape and torch.equal(nan, torch.isnan(b))
                and torch.equal(a.view(iv)[~nan], b.view(iv)[~nan]))
    return torch.equal(a, b)


def _postprocess_calls(device="cpu"):
    """(wrapper call, plain call) for each postprocess kernel."""
    heads, table, thr, t, cnt, off = _postprocess_inputs(device)
    rows, phys, p, is_eq = lookup_fetch_reference(table, off, 700)
    return [
        (lambda: fused_cells_stage1(heads, 3, 85), lambda: fused_cells_stage1_reference(heads, 3, 85)),
        (lambda: lookup_fetch(table, off, 700), lambda: lookup_fetch_reference(table, off, 700)),
        (lambda: select_extract(table, phys, p, is_eq, t, thr),
         lambda: select_extract_reference(table, phys, p, is_eq, t, thr)),
        (lambda: compact_place(table, cnt, off, t, thr, 700),
         lambda: compact_place_reference(table, cnt, off, t, thr, 700)),
    ]


# the stage-2 slot kernels' cases: (bsz, m, k, thr) shapes, the serving and
# eval tables at batch 8, a small one at batch 1, k = 700 (not a multiple
# of 32) at batch 32 and the serving table at batch 16, each with a random,
# tied, sparse, empty and dense table; then the module's postprocess inputs
# (k = 700 and 5).  select_extract gives a run of 32 slots 4 warps at the
# small grids (batch 1 and 8 serving, the module's inputs), 2 at batch 16
# and 1 at the others
SLOT_SHAPES = [(8, 325, 512, 0.25), (8, 2565, 4096, 0.005), (1, 40, 300, 0.25), (32, 325, 700, 0.25),
               (16, 325, 512, 0.25)]
SLOT_CASES = {"random": "random", "ties": "ties", "few": "fewer", "empty": "random", "dense": "dense"}
SLOT_ROWS = [pytest.param(case, *shape, id=f"{case}-B{shape[0]}-m{shape[1]}-k{shape[2]}")
             for case in SLOT_CASES for shape in SLOT_SHAPES]
SLOT_ROWS.append(pytest.param("inputs", 2, 40, 700, 0.25, id="inputs-B2-m40-k700"))


def _slot_inputs(device, case, bsz, m, k, thr):
    """(table, off, t, thr_bits, ks) of a SLOT_ROWS row: the table, its
    tier offsets and k-th value bits at k, and the k to run."""
    if case == "inputs":
        _, table, thr_bits, t, _, off = _postprocess_inputs(device)
        return table, off, t, thr_bits, (k, 5)
    table = _score_table(device, bsz, m, SLOT_CASES[case], seed=k)
    if case == "empty":
        table = table * (thr * 0.99)
    thr_bits = int(np.float32(thr).view(np.int32))
    t, cg, ce = bisect_count_reference(table, k, thr_bits)
    cnt = torch.cat([cg, ce], 1)
    return table, (cnt.cumsum(1, dtype=torch.int32) - cnt).contiguous(), t, thr_bits, (k,)


@pytest.mark.cuda
@pytest.mark.parametrize("case,bsz,m,k,thr", SLOT_ROWS)
def test_lookup_fetch_kernel_matches_plain(cuda_device, case, bsz, m, k, thr):
    table, off, _, _, ks = _slot_inputs(cuda_device, case, bsz, m, k, thr)
    for k in ks:
        got = lookup_fetch(table, off, k)
        want = lookup_fetch_reference(table, off, k)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert _same_bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("meta", ["lookup", "out_of_range"])
@pytest.mark.parametrize("case,bsz,m,k,thr", SLOT_ROWS)
def test_select_extract_kernel_matches_plain(cuda_device, case, bsz, m, k, thr, meta):
    """On the lookup's own metadata, and on phys in [-2, m + 2), p in
    [-2, 130) and random tiers, where most slots miss: (0.0, 0)."""
    table, off, t, thr_bits, ks = _slot_inputs(cuda_device, case, bsz, m, k, thr)
    _, phys, p, is_eq = lookup_fetch_reference(table, off, ks[0])
    if meta == "out_of_range":
        rng = np.random.default_rng(m + k)
        bsz, m, k = phys.shape[0], table.shape[1], phys.shape[1]
        phys, p, is_eq = (torch.from_numpy(x).to(cuda_device) for x in (
            rng.integers(-2, m + 2, (bsz, k)).astype(np.int32),
            rng.integers(-2, 130, (bsz, k)).astype(np.int32),
            rng.integers(0, 2, (bsz, k)).astype(bool)))
    got = select_extract(table, phys, p, is_eq, t, thr_bits)
    want = select_extract_reference(table, phys, p, is_eq, t, thr_bits)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _same_bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("case,bsz,m,k,thr", SLOT_ROWS)
def test_lookup_fetch_variant_kernel_matches_plain(cuda_device, case, bsz, m, k, thr, variant):
    table, off, _, _, ks = _slot_inputs(cuda_device, case, bsz, m, k, thr)
    for k in ks:
        got = lookup_fetch_variant(table, off, k, variant)
        want = lookup_fetch_variant_reference(table, off, k, variant)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert (a is None and b is None) or _same_bits(a, b)
        if variant == "full":
            assert all(_same_bits(a, b) for a, b in zip(got, lookup_fetch(table, off, k)))


def test_postprocess_kernels_take_the_plain_versions_on_cpu():
    reset_launch_counts()
    for run, plain in _postprocess_calls():
        for a, b in zip(run(), plain()):
            assert _same_bits(a, b)
    assert [fn.launches for fn in KERNELS] == [0] * len(KERNELS)
    assert not _build._loaded


def test_postprocess_kernels_raise_on_other_devices():
    heads, table, thr, t, cnt, off = (x if isinstance(x, int) else
                                      ([h.to("meta") for h in x] if isinstance(x, list) else x.to("meta"))
                                      for x in _postprocess_inputs())
    idx = torch.zeros(2, 5, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_cells_stage1(heads, 3, 85)
    with pytest.raises(ValueError, match="cuda or cpu"):
        lookup_fetch(table, off, 5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        select_extract(table, idx, idx, idx.bool(), t, thr)
    with pytest.raises(ValueError, match="cuda or cpu"):
        compact_place(table, cnt, off, t, thr, 5)


def test_postprocess_kernels_check_their_inputs():
    heads, table, thr, t, cnt, off = _postprocess_inputs()
    idx = torch.zeros(2, 5, dtype=torch.int32)
    with pytest.raises(ValueError, match="levels"):
        fused_cells_stage1(heads * 2, 3, 85)  # five levels
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_cells_stage1([h.double() for h in heads], 3, 85)
    with pytest.raises(ValueError, match="one dtype"):
        fused_cells_stage1([heads[0], heads[1].bfloat16()], 3, 85)
    with pytest.raises(ValueError, match=r"\(B, \.\.\., 255\)"):
        fused_cells_stage1([heads[0][..., :200]], 3, 85)
    with pytest.raises(ValueError, match="kw"):
        fused_cells_stage1([heads[0][..., :15]], 3, 5)
    with pytest.raises(ValueError, match="off"):
        lookup_fetch(table, off.long(), 5)
    with pytest.raises(ValueError, match="off"):
        lookup_fetch(table, off[:, :-1], 5)
    with pytest.raises(ValueError, match="k must be"):
        lookup_fetch(table, off, 0)
    with pytest.raises(ValueError, match="table"):
        lookup_fetch(table[..., :64], off, 5)
    with pytest.raises(ValueError, match=r"must be \(B, k\)"):
        select_extract(table, idx, idx[:, :3], idx.bool(), t, thr)
    with pytest.raises(ValueError, match="t must be"):
        select_extract(table, idx, idx, idx.bool(), t[:1], thr)
    with pytest.raises(ValueError, match="thr_bits"):
        select_extract(table, idx, idx, idx.bool(), t, -1)
    with pytest.raises(ValueError, match="cnt"):
        compact_place(table, cnt.long(), off, t, thr, 5)
    with pytest.raises(ValueError, match="t must be"):
        compact_place(table, cnt, off, t.long(), thr, 5)
    with pytest.raises(ValueError, match="k must be"):
        compact_place(table, cnt, off, t, thr, 0)


@pytest.mark.parametrize("field,value", [("s1_impl", "auto"), ("s1_impl", "sortidx"),
                                         ("row_gather", "xla"), ("row_gather", "auto"),
                                         ("cell_gather", "auto"), ("cell_gather", "mxu"),
                                         ("box_gather", "auto"), ("box_gather", "mxu")])
def test_unknown_postprocess_routes_raise(field, value):
    # the port has one stage 1 (the fused kernel) and plain gathers for the
    # cell rows and boxes, so the JAX package's s1_impl, cell_gather and
    # box_gather are refused as unknown arguments, never ignored
    error = ValueError if field == "row_gather" else TypeError
    with pytest.raises(error, match=field):
        NMSConfig(num_classes=80, **{field: value})
    heads, *_ = _postprocess_inputs()
    with pytest.raises(error, match=field):
        batched_postprocess_from_heads(heads, (8, 16, 32), ((10, 13, 16, 30, 33, 23),) * 3,
                                       num_classes=80, **{field: value})


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", [0, 3], ids=["fused_cells_stage1", "compact_place"])
def test_postprocess_kernels_match_plain(cuda_device, kernel):
    # lookup_fetch's and select_extract's cases are SLOT_ROWS
    run, plain = _postprocess_calls(cuda_device)[kernel]
    got, want = run(), plain()
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert _same_bits(a, b)


P5_640 = ((80, 80), (40, 40), (20, 20))
# name: (batch, level sizes (H, W), kw); C = 3 * kw
STAGE1_CASES = {
    "8x640 special": (8, P5_640, 85),  # chip_smoke.logit_levels' NaN / inf / sub-floor logits
    "4x480x640": (4, ((60, 80), (30, 40), (15, 20)), 85),  # bf16: tiles start 8 bytes off
    "one level 5x7 kw 9": (3, ((5, 7),), 9),
    "P6 at 640": (2, (*P5_640, (10, 10)), 85),
    "P6 at 1280": (8, ((160, 160), (80, 80), (40, 40), (20, 20)), 85),
    "P6 on 768x1280": (8, ((96, 160), (48, 80), (24, 40), (12, 20)), 85),  # a 720p frame
    "offset views": (3, ((20, 20), (10, 10), (5, 5)), 85),  # bases 1 and 3 elements into a buffer
    "B=1": (1, P5_640, 85),
    "B=32": (32, P5_640, 85),
}


def _stage1_levels(name, device, dtype):
    """Head levels (B, H, W, 3 * kw) of a STAGE1_CASES case, with NaN, +-inf,
    logits below -1e4 and one anchor's classes all -inf in every level."""
    bsz, sizes, kw = STAGE1_CASES[name]
    if name == "8x640 special":
        spec = importlib.util.spec_from_file_location("chip_smoke", PKG.parent / "chip_smoke.py")
        smoke = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(smoke)
        return smoke.logit_levels(30, bsz, device, dtype, special=True)
    rng = np.random.default_rng(len(name) + bsz)
    levels = []
    for i, (h, w) in enumerate(sizes):
        x = (rng.standard_normal((bsz, h, w, 3 * kw)) * 3).astype(np.float32)
        flat = x.reshape(-1)
        flat[rng.choice(flat.size, 6, replace=False)] = [np.nan, np.inf, -np.inf, -3e4, np.nan, -2e4]
        x[0, 0, 0, 4] = x[0, 0, 0, kw + 5] = np.nan  # obj of anchor 0, a class of anchor 1
        x[-1, h - 1, w - 1, 5:kw] = -np.inf  # every class of anchor 0: the floor
        t = torch.from_numpy(x).to(device=device, dtype=dtype)
        if name == "offset views" and i < 2:  # a contiguous view 2i + 1 elements into a buffer
            buf = torch.zeros(t.numel() + 2 * i + 5, dtype=dtype, device=device)
            t = buf[2 * i + 1: 2 * i + 1 + t.numel()].view(t.shape).copy_(t)
        levels.append(t)
    return levels


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", [*STAGE1_CASES, "strided"])
def test_fused_cells_stage1_kernel_bf16_and_strided_levels(cuda_device, case, dtype):
    """The kernel against the plain version, bit for bit (NaN positions
    compared as NaN), at every level geometry and base alignment; a
    strided level raises."""
    if case == "strided":
        heads, *_ = _postprocess_inputs(cuda_device, dtype)
        strided = heads[0].permute(0, 2, 1, 3)  # (B, W, H, C): not contiguous
        with pytest.raises(ValueError, match="contiguous"):
            fused_cells_stage1([strided], 3, 85)
        return
    levels = _stage1_levels(case, cuda_device, dtype)
    kw = STAGE1_CASES[case][2]
    got = fused_cells_stage1(levels, 3, kw)
    want = fused_cells_stage1_reference(levels, 3, kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == dtype and _same_bits(a, b)
    floor = float(torch.tensor(-1e4, dtype=dtype))  # -9984 in bfloat16
    assert torch.isnan(got[1]).any() and torch.isnan(got[2]).any() and (got[2] == floor).any()


@pytest.mark.cuda
def test_stage1_plan_fits_the_card(cuda_device):
    """The C side's tile plan: 16 KB tiles of a multiple of 8 rows at C =
    255, 4 stages within a block's shared memory, several blocks an SM."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for dtype, rows in ((torch.float32, 16), (torch.bfloat16, 32)):
        plan = stage1_plan(255, dtype)
        assert plan.rows == rows and plan.stage_bytes == 16320 + 16
        assert plan.stages == 4 and plan.smem <= 232448 and plan.grid >= 2 * sms


def test_stage1_plan_refuses_other_dtypes_without_building():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        stage1_plan(255, torch.float16)


@pytest.mark.cuda
def test_every_kernel_counts_its_launches(cuda_device):
    """Each wrapper adds one to its count per launch and nothing else does."""
    boxes, valid, table, idx = _inputs(cuda_device)
    xq, wq, scale, bias = _qconv_operands(3, 1, 8, 10, 16, 32, seed=1, device=cuda_device)
    calls = {
        nms_mask: lambda: nms_mask(boxes, valid, 0.5),
        bisect_count: lambda: bisect_count(table, 300, 0x3E800000),
        row_fetch: lambda: row_fetch(table, idx),
        qconv1x1: lambda: qconv1x1(xq, wq[:, :16].contiguous(), scale, bias, inv_out_scale=4.0),
        qconv_kxk: lambda: qconv_kxk(xq, wq, scale, bias, k=3, inv_out_scale=4.0),
        qconv_grouped: lambda: qconv_grouped(xq, wq[:, :36].contiguous(), scale, bias, k=3,
                                             groups=4, inv_out_scale=4.0),
    }
    for fn, (run, _) in zip((fused_cells_stage1, lookup_fetch, select_extract, compact_place),
                            _postprocess_calls(cuda_device)):
        calls[fn] = run
    _, ptable, _, _, _, off = _postprocess_inputs(cuda_device)
    calls[lookup_fetch_variant] = lambda: lookup_fetch_variant(ptable, off, 700, "no_boundary")
    calls[row_fetch_p] = lambda: row_fetch_p(table, idx, 4, 2)
    y = torch.randn(2, 24, 5, 7, device=cuda_device).contiguous(memory_format=torch.channels_last)
    calls[bias_act] = lambda: bias_act(y, torch.randn(24, device=cuda_device), "silu")
    assert set(calls) == set(KERNELS)
    reset_launch_counts()
    for i, fn in enumerate(KERNELS):
        calls[fn]()
        torch.cuda.synchronize()
        assert [g.launches for g in KERNELS] == [1] * (i + 1) + [0] * (len(KERNELS) - i - 1)
