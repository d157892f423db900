#!/usr/bin/env python3
"""Smoke run of yolort_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: needs CUDA; prints the card's name and power limit; TF32 off;
  2. build: compiles the CUDA kernels from yolort_tpu_torch/csrc/ (one
     nvcc per source, in parallel);
  3. kernels: nms_mask, bisect_count, row_fetch, fused_cells_stage1,
     lookup_fetch, select_extract, compact_place and the five variants of
     lookup_fetch_variant against their plain PyTorch versions on the
     card, at the main path's shapes, batch 8: nms_mask's whole mask at
     K = 512, 4096 and 16448 (with the tiles its walk visits),
     bisect_count at the stage-1 (197,128) and stage-2 (325,128),
     (2565,128) tables, streamed (5000,128) and (12500,128) ones and the
     tie, few and empty cases, each timed shape beside torch.topk, and at
     every cluster size and mode within bisect_plan's shared-memory budget
     on the two main-path tables; lookup_fetch, select_extract (on the
     lookup's metadata and on out-of-range metadata), compact_place and
     the variants at the (325,128) k = 512 and (2565,128) k = 4096 tables,
     random, tied, few, none-valid and dense at batch 8 and random at
     batch 1 and 32 (the variant 'full' also against lookup_fetch), the
     first three timed at both tables; row_fetch_p at every swept geometry against
     its plain version at both sweep shapes (experiments/
     fetch_block_sweep.py), batch 8; fused_cells_stage1 (its tile plan
     printed) at 8x640 with and without special logits, at 4x480x640 and
     at batch 32, in both dtypes, timed at batch 8 and 32 beside its
     bound, its plain version and torch.cat alone; results must be
     bit-identical (NaN positions compared as NaN); compact_select must
     equal select_topk_threshold on the same scores;
  4. slice: yolov5s at full width, seeded random weights with the head
     biases shifted to a realistic candidate load, serves uint8 frames of
     three sizes in float32 and bfloat16 under the eval (0.005 / 4096) and
     serving (0.25 / 512) configs, once per stage-2 postprocess route
     (row_gather) of ROUTES; every kernel of a route must have launched
     (the default route exactly fused_cells_stage1 1, nms_mask 1,
     bisect_count 2, row_fetch 1 per batch), every image must carry
     detections, each route's detections must equal the default route's
     on the same head outputs, and the card's postprocess must agree with
     the CPU run of the port on every route;
  5. int8: the same yolov5s calibrated on 4 batches of 2 letterboxed 640
     frames, quantized and finalized (ops/quantization.py); qconv1x1 and
     qconv_kxk against their plain versions at every distinct conv shape of
     the int8 network at batch 8 @640, on its own activations (int8 and
     float outputs bit-identical), each shape with its tile, its device
     time (CUDA graph replay), bound, share of bound and TOP/s, and the
     sums weighted by the launches of a forward; then the int8 model
     serves the same requests in both dtypes and configs: both qconv
     kernels and the postprocess kernels must launch, every image must
     carry detections, one request served on each other route must launch
     that route's kernels and equal the default route's detections, and
     the card's int8 head outputs must agree with the CPU run of the port
     on one 480x640 frame within the bound printed there;
  6. times: each kernel's time beside its plain version's, its bound and
     the time of a PyTorch call that computes the same function where
     there is one (the stage-2 row kernels, whose table and stores fit in
     L2, also cold, with the L2 flushed before each launch, and their
     share of the bound taken of that time); images/s of the float and int8 slices at batch 32; the
     postprocess's time per route at batch 32 in both configs and dtypes;
     then the two timing entry points at batch 128 (python -m
     yolort_tpu_torch.experiments.lookup_kernel_variants and
     .fetch_block_sweep: each checks its kernel against the plain version
     and prints its times), each with the launch counts read around it.
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

from yolort_tpu_torch.experiments.timing import (
    PEAK_OPS_PER_S, abs_err, bound, card_line, cold_ms, device_profile, distinct_rows, fmt_ms,
    fmt_share, graph_ms, median_ms, same_bits,
)

B = 8  # images per kernel check
EVAL = dict(score_thresh=0.005, pre_nms_topk=4096)
SERVING = dict(score_thresh=0.25, pre_nms_topk=512)
TPU_KERNELS = {
    "nms_mask": ("yolort_tpu_torch/csrc/nms_mask.cu",
                 "yolort_tpu/ops/pallas/nms_kernel.py:149"),
    "bisect_count": ("yolort_tpu_torch/csrc/bisect_count.cu",
                     "yolort_tpu/ops/pallas/lookup_kernel.py:382"),
    "row_fetch": ("yolort_tpu_torch/csrc/row_fetch.cu",
                  "yolort_tpu/ops/pallas/lookup_kernel.py:481"),
    "qconv1x1": ("yolort_tpu_torch/csrc/qconv.cu", "yolort_tpu/ops/pallas/qconv.py:144"),
    "qconv_kxk": ("yolort_tpu_torch/csrc/qconv.cu", "yolort_tpu/ops/pallas/qconv.py:238"),
    "fused_cells_stage1": ("yolort_tpu_torch/csrc/cells_stage1.cu",
                           "yolort_tpu/ops/pallas/s1_kernel.py:173"),
    "lookup_fetch": ("yolort_tpu_torch/csrc/lookup_fetch.cu",
                     "yolort_tpu/ops/pallas/lookup_kernel.py:238"),
    "select_extract": ("yolort_tpu_torch/csrc/select_extract.cu",
                       "yolort_tpu/ops/pallas/lookup_kernel.py:433"),
    "compact_place": ("yolort_tpu_torch/csrc/compact_select.cu",
                      "yolort_tpu/ops/pallas/compact_kernel.py:171"),
    "lookup_fetch_variant": ("yolort_tpu_torch/csrc/lookup_fetch.cu",
                             "tools/experiments/lookup_kernel_variants.py:109"),
    "row_fetch_p": ("yolort_tpu_torch/csrc/row_fetch.cu",
                    "tools/experiments/fetch_block_sweep.py:89"),
}
# stage-2 postprocess routes (row_gather), the default first, and the
# kernels each one launches
ROUTES = ("pallas_bisect", "pallas_lookup", "pallas_full")
DEFAULT_ROUTE = ROUTES[0]
ROUTE_KERNELS = {
    route: ("fused_cells_stage1", "nms_mask", "bisect_count", fetch)
    for route, fetch in zip(ROUTES, ("row_fetch", "lookup_fetch", "select_extract"))
}
DEFAULT_PER_BATCH = {"fused_cells_stage1": 1, "nms_mask": 1, "bisect_count": 2, "row_fetch": 1}
# the timing entry points, each with the kernel it runs
ENTRY_POINTS = {"lookup_kernel_variants": "lookup_fetch_variant", "fetch_block_sweep": "row_fetch_p"}


# --------------------------------------------------------------------------
# phase 3 inputs
# --------------------------------------------------------------------------

def nms_inputs(seed: int, bsz: int, k: int, device):
    """Score-sorted, class-offset candidates, 70% valid: (boxes, valid,
    scores, labels, offset_boxes)."""
    import torch

    rng = np.random.default_rng(seed)
    cxy = rng.uniform(0, 400, (bsz, k, 2))
    wh = rng.uniform(5, 200, (bsz, k, 2))
    boxes = np.clip(np.concatenate([cxy - wh / 2, cxy + wh / 2], -1), 0, 640).astype(np.float32)
    labels = rng.integers(0, 4, (bsz, k)).astype(np.int32)
    scores = -np.sort(-rng.uniform(0.3, 1.0, (bsz, k)).astype(np.float32), axis=1)
    valid = np.zeros((bsz, k), bool)
    valid[:, : int(k * 0.7)] = True
    t = {n: torch.from_numpy(v).to(device) for n, v in
         dict(boxes=boxes, valid=valid, scores=scores, labels=labels).items()}
    max_coord = torch.where(t["valid"][..., None], t["boxes"], 0.0).amax(dim=(1, 2))
    t["offset"] = (t["boxes"] + (t["labels"].float() * (max_coord[:, None] + 1.0))[..., None]).contiguous()
    return t


def tiles_visited(keep, tile: int, stop: int) -> list:
    """Tiles of ``tile`` candidates the greedy walk visits in each image of
    a plain keep mask: up to the first multiple of ``tile`` with ``stop``
    keeps before it, else all."""
    k = keep.shape[1]
    n = -(-k // tile)
    ends = [min(i * tile, k) - 1 for i in range(1, n + 1)]
    done = keep.long().cumsum(1)[:, ends] >= stop
    return [int(r.nonzero()[0]) + 1 if r.any() else n for r in done]


def nms_work(keep, valid, tile: int, stop: int):
    """What greedy NMS with the early exit needs, read from a plain keep
    mask (B, K) and its valid mask: (bytes, IoU pairs).  Each image reads
    its boxes (16 B each) up to the exit, reads ``valid`` and writes
    ``keep`` (1 B each of all K); each valid candidate before the exit is
    tested against the boxes kept before it, and none after it.  The exit
    is the first multiple of ``tile`` with ``stop`` keeps before it (none
    with ``stop`` <= 0)."""
    bsz, k = keep.shape
    t = min(tile, k)
    exits = ([min(n * t, k) for n in tiles_visited(keep, t, stop)] if stop > 0
             else [k] * bsz)
    before = keep.long().cumsum(1) - keep.long()  # boxes kept before each candidate
    pairs = sum(int((before[b, :e] * valid[b, :e].long()).sum()) for b, e in enumerate(exits))
    return 16 * sum(exits) + 2 * bsz * k, pairs


def score_table(seed: int, bsz: int, m: int, device, valid_frac: float = 1.0,
                ties: bool = False, dense: bool = False):
    """(B, m, 128) sigmoid-product scores; entries past valid_frac zeroed;
    ``ties`` rounds them to 40 levels (boundary tie storms); ``dense``
    sorts each image's scores descending and lifts them into [0.5, 1), so
    every entry is valid and the top k fill whole chunk rows."""
    import torch

    rng = np.random.default_rng(seed)
    a = rng.standard_normal((bsz, m * 128)) * 2.0 - 1.0
    c = rng.standard_normal((bsz, m * 128)) * 2.0 - 1.0
    s = (1 / (1 + np.exp(-a))) * (1 / (1 + np.exp(-c)))
    if ties:
        s = np.round(s * 40) / 40
    s[:, int(m * 128 * valid_frac):] = 0.0
    if dense:
        s = 0.5 + 0.5 * -np.sort(-s, axis=-1)
    return torch.from_numpy(s.astype(np.float32).reshape(bsz, m, 128)).to(device)


def special_table(seed: int, bsz: int, m: int, w: int, dtype, device):
    """A random table with sign/exponent corners and NaN payloads."""
    import torch

    rng = np.random.default_rng(seed)
    tab = rng.standard_normal((bsz, m, w)).astype(np.float32)
    specials = np.asarray([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45,
                           3.4e38, -3.4e38, 0.005, 1e-8], np.float32)
    tab[:, : len(specials), 0] = specials
    tab[:, : len(specials), w - 1] = specials[::-1]
    t = torch.from_numpy(tab)
    if dtype == torch.bfloat16:
        t = t.to(torch.bfloat16)
        bits = t.view(torch.int16)
        bits[:, 20, 5] = -(2**15)
        bits[:, 21, 5] = 2**15 - 1
        bits[:, 22, 5] = 0x7FC1  # a NaN with a payload
    else:
        bits = t.view(torch.int32)
        bits[:, 20, 5] = -(2**31)
        bits[:, 21, 5] = 2**31 - 1
        bits[:, 22, 5] = 0x7FC00123
    return t.to(device)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| count {torch.cuda.device_count()}", flush=True)
    return card


def phase_build():
    from yolort_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.library()
    dt = time.perf_counter() - t0
    log = path.with_suffix(".log").read_text() if path.with_suffix(".log").exists() else ""
    print(f"[build] {path.name} from yolort_tpu_torch/csrc/{{{','.join(_build.SOURCES)}}} "
          f"in {dt:.1f} s", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "error" in line.lower():
            print(f"[build]   {line.strip()}")
    return dt


def phase_kernels(device, card: str) -> dict:
    """Each kernel against its plain version, bit for bit, and timed."""
    import torch

    from yolort_tpu_torch.ops.boxes import box_iou_matrix
    from yolort_tpu_torch.ops.cuda import (
        bisect_count, bisect_count_reference, nms_mask, nms_mask_reference,
        row_fetch, row_fetch_reference,
    )
    from yolort_tpu_torch.ops.cuda.lookup_kernel import (
        BISECT_SMEM_BYTES, ROW_BYTES, BisectPlan, _launch_bisect, bisect_plan,
    )
    from yolort_tpu_torch.ops.nms import _compact_detections

    res = {}
    # --- nms_mask --------------------------------------------------------
    err = 0.0
    by_k = {}
    for seed, k in ((0, 512), (1, 4096), (2, 16448)):
        t = nms_inputs(seed, B, k, device)
        run = lambda t=t: nms_mask(t["offset"], t["valid"], 0.45, 256, 300)  # noqa: E731
        plain = lambda t=t: nms_mask_reference(t["offset"], t["valid"], 0.45, 256, 300)  # noqa: E731
        got, ref = run(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):  # the whole mask, past the early exit too
            raise AssertionError(f"nms_mask K={k}: the mask differs from the plain version's")
        dg = _compact_detections(got, t["boxes"], t["scores"], t["labels"], 300)
        dr = _compact_detections(ref, t["boxes"], t["scores"], t["labels"], 300)
        for a, b in zip(dg, dr):
            if not torch.equal(a, b):
                raise AssertionError(f"nms_mask K={k}: compacted detections differ")
            err = max(err, (a.double() - b.double()).abs().max().item())
        tiles = tiles_visited(ref, 256, 300)
        print(f"[kernels] nms_mask B={B} K={k}: whole mask equal, compacted equal, 256-candidate "
              f"tiles visited/img {tiles}", flush=True)
        ms, pms = median_ms(run), median_ms(plain, 5)
        dev, pdev = device_profile(run)[0], device_profile(plain)[0]
        # bound: what greedy NMS needs up to the early exit, 12 f32
        # operations per (candidate, earlier kept box) IoU pair
        nbytes, pairs = nms_work(ref, t["valid"], 256, 300)
        bms, bby = bound(nbytes, 12.0 * pairs)
        print(f"[times] nms_mask B={B} K={k}: kernel {ms:.4f} ms (device {fmt_ms(dev)}), "
              f"plain {pms:.4f} ms (device {fmt_ms(pdev)}), bound {bms:.6f} ms ({bby}; "
              f"{nbytes} B, {pairs} IoU pairs) | {card}", flush=True)
        by_k[k] = dict(ms=ms, device_ms=dev, plain_ms=pms, plain_device_ms=pdev, bound_ms=bms,
                       bound_by=bby, bound_bytes=nbytes, bound_iou_pairs=pairs,
                       tiles_visited=tiles)
        if k == 4096:
            partial = median_ms(lambda t=t: box_iou_matrix(t["offset"], t["offset"]))
    res["nms_mask"] = dict(
        max_abs_err=err, **by_k[4096], library_ms=None, library_call=None,
        nearest_partial="ops.boxes.box_iou_matrix (the IoU matrix alone; torchvision.ops.nms is "
                        "outside core PyTorch)",
        nearest_partial_ms=partial, by_k={k: v for k, v in by_k.items() if k != 4096},
        at=f"B={B}, K=4096, stop_after=300")

    # --- bisect_count ----------------------------------------------------
    cases = [  # (name, table, k, thr): stage 1 runs on the per-anchor scores, threshold 0
        ("stage-1 eval", score_table(7, B, 197, device), 4104, 0.0),
        ("stage-1 serving", score_table(8, B, 197, device), 520, 0.0),
        ("serving", score_table(2, B, 325, device), 512, 0.25),
        ("eval", score_table(3, B, 2565, device), 4096, 0.005),
        ("pre_nms_topk=20000", score_table(9, B, 12500, device), 20000, 0.005),
        ("pre_nms_topk=8000", score_table(12, B, 5000, device), 8000, 0.005),
        ("eval ties", score_table(10, B, 2565, device, ties=True), 4096, 0.005),
        ("fewer-than-k", score_table(4, B, 325, device, valid_frac=0.002), 512, 0.25),
        ("none-valid", score_table(5, B, 325, device) * 0.1, 512, 0.25),
    ]
    timed = ("stage-1 eval", "stage-1 serving", "serving", "eval", "pre_nms_topk=20000")
    err = 0.0
    shapes = {}
    for name, tab, k, thr in cases:
        thr_bits = int(np.float32(thr).view(np.int32))
        got = bisect_count(tab, k, thr_bits)
        ref = bisect_count_reference(tab, k, thr_bits)
        for a, b in zip(got, ref):
            if not torch.equal(a, b):
                raise AssertionError(f"bisect_count {name}: differs from the plain version")
            err = max(err, (a.double() - b.double()).abs().max().item())
        plan = bisect_plan(B, tab.shape[1])
        print(f"[kernels] bisect_count {name} {tuple(tab.shape)} k={k}: equal, cluster "
              f"{plan.cluster} {'resident' if plan.resident else 'streamed'}, "
              f"t={[hex(v) for v in got[0][:2].tolist()]}", flush=True)
        if name not in timed:
            continue
        run = lambda tab=tab, k=k, tb=thr_bits: bisect_count(tab, k, tb)  # noqa: E731
        plain = lambda tab=tab, k=k, tb=thr_bits: bisect_count_reference(tab, k, tb)  # noqa: E731
        flat = tab.reshape(B, -1)
        topk = lambda flat=flat, k=k: torch.topk(flat, k, dim=1)  # noqa: E731
        ms, pms, tms = median_ms(run), median_ms(plain, 5), median_ms(topk)
        dev, pdev, tdev = device_profile(run)[0], device_profile(plain)[0], device_profile(topk)[0]
        m = tab.shape[1]
        bms, bby = bound(B * m * 128 * 4 + B * 4 + 2 * B * m * 4)
        print(f"[times] bisect_count B={B} {name} ({m},128) k={k}: kernel {ms:.4f} ms (device "
              f"{fmt_ms(dev)}), plain {pms:.4f} ms (device {fmt_ms(pdev)}), torch.topk {tms:.4f} ms "
              f"(device {fmt_ms(tdev)}), bound {bms:.4f} ms ({bby}) | {card}", flush=True)
        shapes[name] = dict(ms=ms, device_ms=dev, plain_ms=pms, plain_device_ms=pdev, bound_ms=bms,
                            bound_by=bby, topk_ms=tms, topk_device_ms=tdev, cluster=plan.cluster,
                            resident=plan.resident, at=f"({m},128) k={k}")
    # every cluster size and mode at the two main-path tables, at batch 8
    # and 32: what bisect_plan chooses from
    plans = {}
    for bsz, name, m, k, thr in ((B, "stage-1 eval", 197, 4104, 0.0), (B, "eval", 2565, 4096, 0.005),
                                 (32, "stage-1 eval", 197, 4104, 0.0), (32, "eval", 2565, 4096, 0.005)):
        tab = score_table(11, bsz, m, device)
        thr_bits = int(np.float32(thr).view(np.int32))
        line = []
        for cluster in (4, 8, 16):
            for resident in (True, False):
                if resident and -(-m // cluster) * ROW_BYTES > BISECT_SMEM_BYTES:
                    continue
                p = BisectPlan(cluster, resident)
                run = lambda tab=tab, k=k, tb=thr_bits, p=p: _launch_bisect(tab, k, tb, p)  # noqa: E731
                dev = device_profile(run)[0]
                tag = f"{cluster}{'r' if resident else 's'}"
                plans[f"B={bsz} {name} {tag}"] = dev
                line.append(f"{tag} {fmt_ms(dev)}")
        print(f"[times] bisect_count B={bsz} {name} ({m},128) device ms by plan (cluster size, r "
              f"resident, s streamed): {', '.join(line)}; bisect_plan takes "
              f"{tuple(bisect_plan(bsz, m))} | {card}", flush=True)
    res["bisect_count"] = dict(
        max_abs_err=err, **{key: v for key, v in shapes["eval"].items() if key != "at"},
        library_ms=None, library_call=None,
        nearest_partial="torch.topk (the k largest values, no tier counts)",
        nearest_partial_ms=shapes["eval"]["topk_ms"],
        by_shape={n: v for n, v in shapes.items() if n != "eval"}, by_plan=plans,
        at=f"B={B}, (2565,128), k=4096 (stage 2, eval)")

    # --- row_fetch -------------------------------------------------------
    rng = np.random.default_rng(6)
    err = 0.0
    for m, w, k, dtype in ((325, 128, 512, torch.float32), (2565, 128, 4096, torch.float32),
                           (325, 128, 512, torch.bfloat16), (300, 85, 520, torch.bfloat16)):
        tab = special_table(m + k, B, m, w, dtype, device)
        idx = torch.from_numpy(rng.integers(-5, m + 5, (B, k)).astype(np.int32)).to(device)
        idx[:, :30] = torch.arange(30, dtype=torch.int32)
        got = row_fetch(tab, idx)
        ref = row_fetch_reference(tab, idx)
        iv = torch.int32 if dtype == torch.float32 else torch.int16
        if not torch.equal(got.view(iv), ref.view(iv)):
            raise AssertionError(f"row_fetch {dtype} ({m},{w}) k={k}: bits differ")
        # on the bit patterns: NaN payloads count as values too
        err = max(err, (got.view(iv).double() - ref.view(iv).double()).abs().max().item())
        print(f"[kernels] row_fetch {dtype} ({m},{w}) k={k}: bit-identical", flush=True)
        if w == 128 and dtype == torch.float32:
            ms = median_ms(lambda: row_fetch(tab, idx))
            pms = median_ms(lambda: row_fetch_reference(tab, idx))
            dev = device_profile(lambda: row_fetch(tab, idx))[0]
            pdev = device_profile(lambda: row_fetch_reference(tab, idx))[0]
            print(f"[times] row_fetch B={B} ({m},{w}) f32 k={k}: kernel {ms:.4f} ms "
                  f"(device {fmt_ms(dev)}), plain {pms:.4f} ms (device {fmt_ms(pdev)}) | {card}")
            if m == 2565:
                gidx = idx.long().clamp(0, m - 1)[..., None].expand(-1, -1, w)
                lib = median_ms(lambda: torch.gather(tab, 1, gidx))
                bms, bby = bound(B * k * 4 + distinct_rows(idx, m) * w * 4 + B * k * w * 4)
                cold = cold_ms(lambda: row_fetch(tab, idx))
                share = bms / cold if cold else None
                print(f"[times] row_fetch B={B} ({m},{w}) f32 k={k}: cold L2 {fmt_ms(cold)}, "
                      f"{fmt_share(share)} of bound {bms:.5f} ms ({bby}) | {card}", flush=True)
                res["row_fetch"] = dict(
                    ms=ms, plain_ms=pms, device_ms=dev, plain_device_ms=pdev, cold_ms=cold,
                    bound_ms=bms, bound_by=bby, device_share_of_bound=share, library_ms=lib,
                    library_call="torch.gather (clamped indices)", at=f"B={B}, (2565,128) f32, k=4096")
    res["row_fetch"]["max_abs_err"] = err
    return res


def phase_sweep_kernels(device, card: str) -> dict:
    """row_fetch_p at every swept geometry against its plain version at
    both sweep shapes, batch 8, bit for bit; then row_fetch's geometry
    (8, 1) timed at each beside the plain version, torch.gather and the
    bound."""
    from yolort_tpu_torch.experiments import fetch_block_sweep as sweep

    err, out = 0.0, {}
    for name, (tab, idx) in sweep.make_inputs(B, device, seed=50).items():
        label = sweep.LABELS[name]
        err = max(err, sweep.check(tab, idx, label=f"B={B} {label}"))
        print(f"[kernels] row_fetch_p B={B} {label}: all {len(sweep.GEOMETRIES)} geometries "
              f"bit-identical", flush=True)
        r = sweep.measure(tab, idx, card, geometries=((8, 1),), label=label, tag="[times] row_fetch_p")
        bms, bby = r["bound"]
        cold = r[(8, 1)]["cold_ms"]
        out[name] = dict(ms=r[(8, 1)]["ms"], device_ms=r[(8, 1)]["device_ms"], cold_ms=cold,
                         plain_ms=r["plain"]["ms"], plain_device_ms=r["plain"]["device_ms"],
                         bound_ms=bms, bound_by=bby, device_share_of_bound=bms / cold if cold else None,
                         library_ms=r["library"]["ms"], library_device_ms=r["library"]["device_ms"])
    return {"row_fetch_p": dict(
        **out["cells"], library_call="torch.gather (clamped indices)", max_abs_err=err,
        stage2=out["stage2"], at=f"B={B}, {sweep.LABELS['cells']}, geometry (8, 1); stage2: "
                                f"{sweep.LABELS['stage2']}")}


S640 = ((80, 80), (40, 40), (20, 20))  # yolov5s head levels @640
S480 = ((60, 80), (30, 40), (15, 20))  # @480x640: a 300-row level


def logit_levels(seed: int, bsz: int, device, dtype, special: bool = False, sizes=S640):
    """Head logits of the three yolov5s levels, (B, H, W, 255) NHWC, at
    ``sizes`` (@640 by default); ``special`` puts NaN, +-inf and logits
    below -1e4 in the last level (B >= 2, last level 6x6 or larger)."""
    import torch

    rng = np.random.default_rng(seed)
    levels = [rng.standard_normal((bsz, h, w, 255), dtype=np.float32) * 3.0 for h, w in sizes]
    if special:
        x = levels[2]
        x[0, 0, 0, 4] = np.nan       # obj of anchor 0
        x[0, 0, 1, 90] = np.nan      # a class of anchor 1
        x[1, 2, 3, 4], x[1, 2, 3, 5] = np.inf, -np.inf
        x[1, 5, 5, 5:85] = -np.inf   # every class of anchor 0
        x[0, 1, 1, 174] = -3e4       # obj of anchor 2
        x[0, 1, 1, 90:170] = -2e4    # every class of anchor 1
    return [torch.from_numpy(x).to(device=device, dtype=dtype) for x in levels]


def phase_postprocess_kernels(device, card: str) -> dict:
    """fused_cells_stage1, lookup_fetch, select_extract and compact_place
    against their plain versions, bit for bit, then timed beside their
    bounds and the nearest PyTorch calls."""
    import torch

    from yolort_tpu_torch.ops.cuda import (
        bisect_count, compact_place, compact_place_reference, fused_cells_stage1,
        fused_cells_stage1_reference, lookup_fetch, lookup_fetch_reference, select_extract,
        select_extract_reference,
    )
    from yolort_tpu_torch.experiments import lookup_kernel_variants
    from yolort_tpu_torch.ops.cuda.lookup_kernel import VARIANTS
    from yolort_tpu_torch.ops.cuda.stage1_kernel import stage1_plan
    from yolort_tpu_torch.ops.select import compact_select, select_topk_threshold

    res = {}
    # --- fused_cells_stage1 ----------------------------------------------
    # bit for bit at 8x640 (special logits and plain), at 4x480x640 (a
    # 300-row level: bfloat16 tiles off 16-byte alignment) and at batch
    # 32; timed at batch 8 and 32 in both dtypes
    err = 0.0
    s1 = {}
    for dtype in (torch.float32, torch.bfloat16):
        plan = stage1_plan(255, dtype)
        print(f"[kernels] fused_cells_stage1 {dtype} plan: {plan.rows} rows a tile, {plan.stages} "
              f"stages of {plan.stage_bytes} B, {plan.smem} B of shared memory a block, "
              f"{plan.grid} blocks", flush=True)
        for bsz, sizes, special in ((B, S640, True), (4, S480, True), (B, S640, False),
                                    (32, S640, False)):
            levels = logit_levels(30 + special + bsz, bsz, device, dtype, special, sizes)
            geometry = "+".join(f"{h}x{w}" for h, w in sizes)
            got = fused_cells_stage1(levels, 3, 85)
            ref = fused_cells_stage1_reference(levels, 3, 85)
            torch.cuda.synchronize()
            for a, b, what in zip(got, ref, ("cells", "obj_max", "cls_max")):
                if not same_bits(a, b):
                    raise AssertionError(f"fused_cells_stage1 {dtype} B={bsz} {geometry} "
                                         f"special={special}: {what} differs")
                err = max(err, abs_err(a, b))
            iv = torch.int32 if dtype == torch.float32 else torch.int16
            nan_bits = all(torch.equal(a.view(iv), b.view(iv)) for a, b in zip(got, ref))
            print(f"[kernels] fused_cells_stage1 {dtype} B={bsz} {geometry} C=255"
                  f"{' with NaN/inf/below-floor logits' if special else ''}: equal "
                  f"(NaN bits too: {nan_bits}), NaNs in maxima "
                  f"{int(torch.isnan(got[1]).sum() + torch.isnan(got[2]).sum())}", flush=True)
            if special or sizes != S640:
                continue
            del got, ref
            run = lambda lv=levels: fused_cells_stage1(lv, 3, 85)  # noqa: E731
            plain = lambda lv=levels: fused_cells_stage1_reference(lv, 3, 85)  # noqa: E731
            flat = [lv.reshape(bsz, -1, 255) for lv in levels]
            cat = lambda flat=flat: torch.cat(flat, dim=1)  # noqa: E731
            ms, pms, cms = median_ms(run), median_ms(plain), median_ms(cat)
            dev, pdev, cdev = device_profile(run)[0], device_profile(plain)[0], device_profile(cat)[0]
            n_cells = sum(h * w for h, w in sizes)
            esize = levels[0].element_size()
            bms, bby = bound(2 * bsz * n_cells * 255 * esize + 2 * bsz * n_cells * 3 * esize)
            share = f"{100 * bms / dev:.1f}%" if dev else "not measured"
            print(f"[times] fused_cells_stage1 B={bsz} {dtype}: kernel {ms:.4f} ms (device "
                  f"{fmt_ms(dev)}, {share} of bound), plain {pms:.4f} ms (device {fmt_ms(pdev)}), "
                  f"torch.cat alone {cms:.4f} ms (device {fmt_ms(cdev)}), bound {bms:.4f} ms "
                  f"({bby}) | {card}", flush=True)
            s1[(bsz, dtype)] = dict(
                ms=ms, plain_ms=pms, device_ms=dev, plain_device_ms=pdev, bound_ms=bms, bound_by=bby,
                nearest_partial_ms=cms, nearest_partial_device_ms=cdev,
                at=f"B={bsz}, 80x80+40x40+20x20, C=255, {str(dtype).split('.')[-1]}")
            del levels, flat
    res["fused_cells_stage1"] = dict(
        **s1[(B, torch.float32)], library_ms=None, library_call=None,
        nearest_partial="torch.cat of the levels (no maxima)", max_abs_err=err,
        others=[s1[key] for key in ((B, torch.bfloat16), (32, torch.float32), (32, torch.bfloat16))])

    # --- lookup_fetch, select_extract, compact_place ------------------------
    cases = []
    for m, k, thr in ((325, 512, 0.25), (2565, 4096, 0.005)):
        cases += [
            ("random", score_table(40 + m, B, m, device), m, k, thr),
            ("ties", score_table(41 + m, B, m, device, ties=True), m, k, thr),
            ("fewer-than-k", score_table(42 + m, B, m, device, valid_frac=0.002), m, k, thr),
            ("none-valid", score_table(43 + m, B, m, device) * (thr * 0.99), m, k, thr),
            ("dense", score_table(45 + m, B, m, device, dense=True), m, k, thr),
            ("random", score_table(46 + m, 1, m, device), m, k, thr),
            ("random", score_table(47 + m, 32, m, device), m, k, thr),
        ]
    errs = dict(lookup_fetch=0.0, select_extract=0.0, compact_place=0.0, lookup_fetch_variant=0.0)
    serving = {}  # the timed kernels at the serving table
    rng = np.random.default_rng(44)
    for name, tab, m, k, thr in cases:
        tab = tab.contiguous()
        bsz = tab.shape[0]
        thr_bits = int(np.float32(thr).view(np.int32))
        t, cg, ce = bisect_count(tab, k, thr_bits)
        cnt = torch.cat([cg, ce], 1).contiguous()
        off = (cnt.cumsum(1, dtype=torch.int32) - cnt).contiguous()
        total = (off[:, -1] + cnt[:, -1]).tolist()
        got = lookup_fetch(tab, off, k)
        ref = lookup_fetch_reference(tab, off, k)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            if not same_bits(a, b):
                raise AssertionError(f"lookup_fetch {name} B={bsz} ({m},128) k={k}: differs from the "
                                     f"plain version")
            errs["lookup_fetch"] = max(errs["lookup_fetch"], abs_err(a, b))
        _, phys, p, is_eq = ref
        miss = (torch.from_numpy(rng.integers(-2, m + 2, (bsz, k)).astype(np.int32)).to(device),
                torch.from_numpy(rng.integers(-2, 130, (bsz, k)).astype(np.int32)).to(device),
                torch.from_numpy(rng.integers(0, 2, (bsz, k)).astype(bool)).to(device))
        for ph, pp, eq in ((phys, p, is_eq), miss):
            got = select_extract(tab, ph, pp, eq, t, thr_bits)
            ref = select_extract_reference(tab, ph, pp, eq, t, thr_bits)
            torch.cuda.synchronize()
            for a, b in zip(got, ref):
                if not same_bits(a, b):
                    raise AssertionError(f"select_extract {name} B={bsz} ({m},128) k={k}: differs from the "
                                         f"plain version")
                errs["select_extract"] = max(errs["select_extract"], abs_err(a, b))
        got = compact_place(tab, cnt, off, t, thr_bits, k)
        ref = compact_place_reference(tab, cnt, off, t, thr_bits, k)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            if not same_bits(a, b):
                raise AssertionError(f"compact_place {name} B={bsz} ({m},128) k={k}: differs from the "
                                     f"plain version")
            errs["compact_place"] = max(errs["compact_place"], abs_err(a, b))
        flat = tab.reshape(bsz, -1)
        cs, st = compact_select(flat, k, thr), select_topk_threshold(flat, k, thr)
        if not (same_bits(cs[0], st[0]) and torch.equal(cs[1], st[1])):
            raise AssertionError(f"compact_select {name} B={bsz} ({m},128) k={k}: differs from "
                                 f"select_topk_threshold")
        errs["lookup_fetch_variant"] = max(errs["lookup_fetch_variant"], lookup_kernel_variants.check(
            tab, off, k, f"{name} B={bsz} ({m},128) k={k}"))
        print(f"[kernels] lookup_fetch, select_extract, compact_place, lookup_fetch_variant x{len(VARIANTS)} "
              f"{name} B={bsz} ({m},128) k={k}: equal (variant full == lookup_fetch); compact_select == "
              f"select_topk_threshold; selected/img {total[:3]}...", flush=True)

        if name != "random" or bsz != B:
            continue
        if m == 2565:
            var = lookup_kernel_variants.measure(tab, off, k, card, tag="[times] lookup_fetch_variant")
            lib = var["library torch.searchsorted (the lookup alone)"]
            res["lookup_fetch_variant"] = dict(
                **var["full"], library_ms=None, library_call=None,
                nearest_partial="torch.searchsorted (the lookup alone, no row fetch)",
                nearest_partial_ms=lib["ms"], variants={v: var[v] for v in VARIANTS},
                at=f"B={B}, ({m},128), k={k}, random table; ms etc. of the variant 'full'")
        t1 = t[:, None, None] + 1
        mask = tab.view(torch.int32) >= t1
        gidx = phys.long()[..., None].expand(-1, -1, 128)
        s_iota = torch.arange(k, dtype=torch.int32, device=device).expand(B, k).contiguous()
        # compact_place reads only the chunks that hold a placed entry
        busy = int(((cnt > 0) & (off < k)).view(B, 2, m).any(1).sum())
        runs = {
            "lookup_fetch": (lambda: lookup_fetch(tab, off, k),
                             lambda: lookup_fetch_reference(tab, off, k),
                             "torch.searchsorted (the lookup alone, no row fetch)",
                             lambda: torch.searchsorted(off, s_iota, right=True),
                             B * 2 * m * 4 + distinct_rows(phys, m) * 512 + B * k * (512 + 9)),
            "select_extract": (lambda: select_extract(tab, phys, p, is_eq, t, thr_bits),
                               lambda: select_extract_reference(tab, phys, p, is_eq, t, thr_bits),
                               "torch.gather of the rows (the fetch alone, no extraction)",
                               lambda: torch.gather(tab, 1, gidx),
                               distinct_rows(phys, m) * 512 + B * k * 9 + B * 4 + B * k * 8),
            "compact_place": (lambda: compact_place(tab, cnt, off, t, thr_bits, k),
                              lambda: compact_place_reference(tab, cnt, off, t, thr_bits, k),
                              "torch.nonzero of the gt-tier mask (compaction alone, no values)",
                              lambda: torch.nonzero(mask),
                              busy * 512 + B * 2 * m * 8 + B * 4 + B * k * 8),
        }
        for kname, (run, plain, pname, pcall, nbytes) in runs.items():
            ms, pms = median_ms(run), median_ms(plain, 5)
            dev, pdev = device_profile(run)[0], device_profile(plain)[0]
            cold = cold_ms(run)
            partial = median_ms(pcall)
            bms, bby = bound(nbytes)
            # the share is of the cold time: the bound moves every byte at
            # the memory rate, and warm, L2 holds the table and the stores
            share = bms / cold if cold else None
            print(f"[times] {kname} B={B} ({m},128) k={k}: kernel {ms:.4f} ms (device {fmt_ms(dev)}, "
                  f"cold L2 {fmt_ms(cold)}, {fmt_share(share)} of bound), plain {pms:.4f} ms (device "
                  f"{fmt_ms(pdev)}), nearest partial {pname} {partial:.4f} ms, bound {bms:.5f} ms "
                  f"({bby}) | {card}", flush=True)
            r = dict(ms=ms, plain_ms=pms, device_ms=dev, plain_device_ms=pdev, cold_ms=cold,
                     bound_ms=bms, bound_by=bby, device_share_of_bound=share, library_ms=None,
                     library_call=None,
                     nearest_partial=pname, nearest_partial_ms=partial,
                     at=f"B={B}, ({m},128), k={k}, random table")
            if m == 2565:
                res[kname] = r
            else:
                serving[kname] = r
    for kname, e in errs.items():
        res[kname]["max_abs_err"] = e
    for kname, r in serving.items():
        res[kname]["others"] = [r]
    return res


def frames(seed: int, n: int, h: int, w: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def calibrate_candidate_density(yolo, requests, target: int = 120, margin: float = 0.5) -> float:
    """Head-bias shift that gives every image at least ``target`` pairs with
    score > 0.25: seeded random weights keep scores near 1e-4, which would
    leave the selection and NMS kernels with no work.  Bisects the shift
    on the model's own logits of the requests' frames, as
    bench.calibrate_candidate_density does, then adds ``margin``: random
    weights make the count a cliff in the shift, and the margin keeps a
    bias rounded to bfloat16 on the busy side of it."""
    import torch

    from yolort_tpu_torch.models.transform import letterbox_batch, make_plan

    dtype = next(yolo.parameters()).dtype
    logits = []
    for raw_u8 in requests:
        x = torch.from_numpy(np.stack(raw_u8)).to(next(yolo.parameters()).device)
        plan = make_plan([tuple(x.shape[1:3])])[0]
        with torch.inference_mode():
            outs = yolo.head_outputs(letterbox_batch(x.to(dtype) / 255.0, plan))
        logits.append(np.concatenate(
            [o.reshape(o.shape[0], -1, 5 + yolo.num_classes).float().cpu().numpy() for o in outs], axis=1))

    def count_at(d):
        counts = []
        for lg in logits:
            obj, cls = lg[..., 4], lg[..., 5:]
            s = 1 / (1 + np.exp(-(obj + d)))[..., None] * (1 / (1 + np.exp(-(cls + d))))
            counts.append((s > 0.25).sum(axis=(1, 2)).min())
        return min(counts)

    lo, hi = 0.0, 20.0
    for _ in range(30):
        mid = (lo + hi) / 2
        if count_at(mid) < target:
            lo = mid
        else:
            hi = mid
    return hi + margin


def shift_head_bias(yolo, delta: float) -> None:
    import torch

    with torch.no_grad():
        for conv in yolo.head.children():
            conv.bias.view(yolo.num_anchors, -1)[:, 4:] += delta


def pair_detections(a, b, label: str) -> int:
    """Pair the card's detections ``a`` with the CPU's ``b`` image by
    image: equal counts, >= 99% paired by label with score within 1e-5
    relative and IoU > 0.999.  Returns the number of unpaired detections."""
    import torch

    from yolort_tpu_torch.ops.boxes import box_iou_matrix

    unpaired = 0
    for i in range(a.num.shape[0]):
        n, n_ref = int(a.num[i]), int(b.num[i])
        if n != n_ref:
            raise AssertionError(f"{label} image {i}: {n} detections on the card, {n_ref} on the CPU")
        if n == 0:
            raise AssertionError(f"{label} image {i}: no detections")
        ba, sa, la = a.boxes[i, :n].cpu().float(), a.scores[i, :n].cpu().float(), a.labels[i, :n].cpu()
        bb, sb, lb = b.boxes[i, :n].float(), b.scores[i, :n].float(), b.labels[i, :n]
        iou = box_iou_matrix(ba, bb)
        ok = ((la[:, None] == lb[None, :]) & (iou > 0.999)
              & ((sa[:, None] - sb[None, :]).abs() <= 1e-5 * sb[None, :].abs()))
        used = torch.zeros(n, dtype=torch.bool)
        paired = 0
        for r in range(n):
            cand = torch.nonzero(ok[r] & ~used).flatten()
            if len(cand):
                used[cand[0]] = True
                paired += 1
        unpaired += n - paired
        if paired < 0.99 * n:
            raise AssertionError(f"{label} image {i}: only {paired}/{n} detections paired")
    return unpaired


def check_served(res, label: str) -> list:
    """Every image carries finite, well-formed detections; returns counts."""
    dets = [d for req in res for d in req]
    for d in dets:
        if not len(d["boxes"]):
            raise AssertionError(f"{label}: an image has no detections")
        if not (np.isfinite(d["boxes"]).all() and np.isfinite(d["scores"]).all()):
            raise AssertionError(f"{label}: non-finite detections")
        if d["boxes"].shape[1] != 4 or not (d["labels"] >= 0).all() or not (d["labels"] < 80).all():
            raise AssertionError(f"{label}: malformed detections")
    return [len(d["boxes"]) for d in dets]


def phase_slice(device, card: str) -> dict:
    import torch

    import yolort_tpu_torch
    from yolort_tpu_torch.models.transform import letterbox_batch, make_plan
    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    requests = [frames(10, 8, 720, 1280), frames(11, 4, 480, 640), frames(12, 1, 1080, 1920)]
    t0 = time.perf_counter()
    models = {dt: yolort_tpu_torch.yolov5s(device=device, dtype=dt, seed=0)
              for dt in (torch.float32, torch.bfloat16)}
    for dt, m in models.items():
        delta = calibrate_candidate_density(m.model, requests)
        shift_head_bias(m.model, delta)
        print(f"[slice] yolov5s {dt} built, head bias shift {delta:.4f}", flush=True)
    print(f"[slice] models ready in {time.perf_counter() - t0:.1f} s", flush=True)

    runs = [(dt, name, cfg) for dt in (torch.float32, torch.bfloat16)
            for name, cfg in (("eval", EVAL), ("serving", SERVING))]
    batches = len(runs) * len(requests)
    launches, outs = {}, {}
    for route in ROUTES:
        for m in models.values():
            m.model.row_gather = route
        reset_launch_counts()
        for dt, name, cfg in runs:
            m = models[dt]
            m.model.score_thresh, m.model.pre_nms_topk = cfg["score_thresh"], cfg["pre_nms_topk"]
            outs[(route, dt, name)] = [m(req) for req in requests]
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in KERNELS}
        launches[route] = counts
        print(f"[slice] route {route}: float path launches over {batches} batches "
              f"{counts}", flush=True)
        for kname, n in counts.items():
            if kname in ROUTE_KERNELS[route] and n <= 0:
                raise AssertionError(f"kernel {kname} was not launched on route {route}")
            if kname not in ROUTE_KERNELS[route] and n:
                raise AssertionError(f"kernel {kname} launched on route {route}, which "
                                     f"does not run it")
        if route == DEFAULT_ROUTE:
            want = {kname: DEFAULT_PER_BATCH.get(kname, 0) * batches for kname in counts}
            if counts != want:
                raise AssertionError(f"default route launches {counts}, want {want}")
    for m in models.values():
        m.model.row_gather = DEFAULT_ROUTE
    for (route, dt, name), res in outs.items():
        counts = check_served(res, f"{route} {dt} {name}")
        if route == DEFAULT_ROUTE:
            print(f"[slice] {str(dt):>14} {name:>7}: detections/img {counts}", flush=True)
            continue
        base = outs[(DEFAULT_ROUTE, dt, name)]
        for req, req0 in zip(res, base):
            for d, d0 in zip(req, req0):
                if not all(np.array_equal(d[key], d0[key]) for key in ("boxes", "scores", "labels")):
                    raise AssertionError(f"{route} {dt} {name}: served detections differ "
                                         f"from the default route's")
    print(f"[slice] every route served the default route's detections exactly", flush=True)

    # on the same head outputs: each route's Detections equal the default
    # route's on the card, and the card agrees with the CPU run of the port
    total_unpaired = {route: 0 for route in ROUTES}
    for dt in (torch.float32, torch.bfloat16):
        yolo = models[dt].model
        for name, cfg in (("eval", EVAL), ("serving", SERVING)):
            yolo.score_thresh, yolo.pre_nms_topk = cfg["score_thresh"], cfg["pre_nms_topk"]
            for req in requests:
                x = torch.from_numpy(np.stack(req)).to(device)
                plan = make_plan([tuple(x.shape[1:3])])[0]
                with torch.inference_mode():
                    heads = yolo.head_outputs(letterbox_batch(x.to(dt) / 255.0, plan))
                heads_cpu = [h.cpu() for h in heads]
                base = None
                for route in ROUTES:
                    yolo.row_gather = route
                    with torch.inference_mode():
                        det_gpu = yolo.postprocess(heads)
                        det_cpu = yolo.postprocess(heads_cpu)
                    label = f"{route} {dt} {name} {tuple(x.shape[1:3])}"
                    if base is None:
                        base = det_gpu
                    elif not all(torch.equal(a, b) for a, b in zip(det_gpu, base)):
                        raise AssertionError(f"{label}: Detections differ from the default route's")
                    un = pair_detections(det_gpu, det_cpu, label)
                    total_unpaired[route] += un
                    print(f"[slice] card vs CPU {label}: counts equal, {un} unpaired"
                          f"{'' if route == DEFAULT_ROUTE else '; equal to the default route'}", flush=True)
                yolo.row_gather = DEFAULT_ROUTE
    print(f"[slice] unpaired card vs CPU by route: "
          f"{ {r: n for r, n in total_unpaired.items()} }", flush=True)
    totals = {kname: sum(launches[r][kname] for r in ROUTES) for kname in launches[DEFAULT_ROUTE]}
    per_batch = {r: {k: n / batches for k, n in launches[r].items() if n}
                 for r in ROUTES}
    return dict(launches=totals, per_batch=per_batch, unpaired=total_unpaired, models=models,
                requests=requests)


def build_int8(device, requests, batch):
    """yolov5s int8 by the bench recipe: the seeded float32 model with its
    head biases shifted, calibrated on 4 batches of 2 letterboxed frames
    of ``batch``, quantized, and its scales finalized on one frame."""
    import torch

    import yolort_tpu_torch
    from yolort_tpu_torch.models.transform import letterbox_batch, make_plan
    from yolort_tpu_torch.ops.blocks import Conv, Conv2dOnly
    from yolort_tpu_torch.ops.quantization import (
        calibrate_activations, finalize_scales, quantize_compute_params,
    )

    t0 = time.perf_counter()
    m = yolort_tpu_torch.yolov5s(device=device, dtype=torch.float32, seed=0)
    delta = calibrate_candidate_density(m.model, requests)
    shift_head_bias(m.model, delta)
    x = torch.from_numpy(np.stack(batch[:8])).to(device)
    plan = make_plan([tuple(x.shape[1:3])])[0]
    cal = [letterbox_batch(x[i:i + 2].float() / 255.0, plan) for i in (0, 2, 4, 6)]
    calibrate_activations(m.model, cal)
    qmodel = quantize_compute_params(m.model)
    finalize_scales(qmodel, cal[0][:1])
    convs = [mod for mod in qmodel.modules() if isinstance(mod, (Conv, Conv2dOnly))]
    if not all(mod.quantized for mod in convs):
        raise AssertionError("yolov5s int8: a conv was left in float")
    torch.cuda.synchronize()
    print(f"[int8] yolov5s head bias shift {delta:.4f}, calibrated on 4x2 frames "
          f"{tuple(cal[0].shape[1:3])}, {len(convs)} convs quantized, scales finalized in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return qmodel


def phase_qconv_kernels(qmodel, batch, device, card: str) -> dict:
    """qconv1x1 and qconv_kxk against their plain versions at every distinct
    conv shape of the int8 yolov5s at batch 8 @640, on the activations the
    network itself produces there; each timed beside its plain version."""
    import torch

    from yolort_tpu_torch.models.transform import letterbox_batch, make_plan
    from yolort_tpu_torch.ops.blocks import Conv, Conv2dOnly
    from yolort_tpu_torch.ops.cuda import (
        qconv1x1, qconv1x1_reference, qconv_kxk, qconv_kxk_reference,
    )
    from yolort_tpu_torch.ops.cuda.qconv_kernel import qconv_plan

    seen, per_forward = {}, {}

    def hook(mod, inputs, output):
        x = inputs[0]
        shape = tuple((x.q if hasattr(x, "q") else x).shape)
        act = "silu" if isinstance(mod, Conv) else "none"
        key = (mod.k, mod.s, mod.pad, shape[1], mod.wq.shape[0], shape[2], shape[3], act,
               mod.os is None)
        seen.setdefault(key, (mod, x))
        per_forward[key] = per_forward.get(key, 0) + 1

    hooks = [mod.register_forward_hook(hook) for mod in qmodel.modules()
             if isinstance(mod, (Conv, Conv2dOnly))]
    x = torch.from_numpy(np.stack(batch[:B])).to(device)
    plan = make_plan([tuple(x.shape[1:3])])[0]
    with torch.inference_mode():
        qmodel.head_outputs(letterbox_batch(x.float() / 255.0, plan))
    for h in hooks:
        h.remove()

    res = {n: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, shapes=0, bound_ms=0.0, bytes_ms=0.0,
                   ops_ms=0.0, graph_ms=0.0, launches_per_forward=0, weighted_graph_ms=0.0,
                   weighted_bound_ms=0.0) for n in ("qconv1x1", "qconv_kxk")}
    res["qconv1x1"].update(library_ms=0.0, library_call="torch._int_mm (the int8 product alone, no "
                           "epilogue; Cout 255 padded to 256 for its multiple-of-8 rule)")
    res["qconv_kxk"].update(library_ms=None, library_call=None,
                            nearest_partial="none timed: core PyTorch has no int8 CUDA conv "
                                            "(torch._int_mm on an im2col matrix is the nearest)")
    calls = {n: [] for n in res}
    for key, (mod, xin) in sorted(seen.items()):
        k, s, pad, cin, cout, h, w, act, float_out = key
        xq, scale, bias, os, ft = mod.qconv_operands(xin)
        args = (xq, mod.wq, scale, bias)
        kw = dict(inv_out_scale=None if os is None else 1.0 / os, out_dtype=ft)
        if k == 1 and s == 1 and pad == 0:
            name = "qconv1x1"
            run = lambda a=args, kw=kw, act=act: qconv1x1(*a, act=act, **kw)  # noqa: E731
            plain = lambda a=args, kw=kw, act=act: qconv1x1_reference(*a, act=act, **kw)  # noqa: E731
        else:
            name = "qconv_kxk"
            g = dict(k=k, stride=s, pad=pad, act=act)
            run = lambda a=args, kw=kw, g=g: qconv_kxk(*a, **g, **kw)  # noqa: E731
            plain = lambda a=args, kw=kw, g=g: qconv_kxk_reference(*a, **g, **kw)  # noqa: E731
        with torch.inference_mode():
            got, ref = run(), plain()
            torch.cuda.synchronize()
            if got.dtype != ref.dtype or got.shape != ref.shape:
                raise AssertionError(f"{name} {k}x{k}/s{s} {cin}->{cout} @{h}x{w}: "
                                     f"{got.dtype} {tuple(got.shape)} vs {ref.dtype} {tuple(ref.shape)}")
            err = (got.double() - ref.double()).abs().max().item()
            if not torch.equal(got, ref):
                raise AssertionError(f"{name} {k}x{k}/s{s} {cin}->{cout} @{h}x{w} {act}: differs from "
                                     f"the plain version (max abs err {err})")
            ms = median_ms(run, 10, 3)
            gms = graph_ms(run)
            pms = median_ms(plain, 2, 3)
            if name == "qconv1x1" and res["qconv1x1"]["library_ms"] is not None:
                # the product alone: (B*H*W, Cin) x (Cin, Cout), Cout padded to 8s
                a = xq.permute(0, 2, 3, 1).reshape(-1, cin)
                npad = -(-cout // 8) * 8
                bmat = torch.zeros(cin, npad, dtype=torch.int8, device=device)
                bmat[:, :cout] = mod.wq[:, :cin].t()
                try:  # the yardstick only: a refusal leaves library_ms None
                    lib = median_ms(lambda a=a, bmat=bmat: torch._int_mm(a, bmat), 10, 3)
                except RuntimeError as e:
                    print(f"[times] torch._int_mm refused {tuple(a.shape)} x {tuple(bmat.shape)}: {e}")
                    res["qconv1x1"]["library_ms"] = lib = None
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], err)
        r["ms"] += ms
        r["graph_ms"] += gms
        r["plain_ms"] += pms
        r["shapes"] += 1
        # bound: activations, packed weights, scale and bias read once, the
        # output written once; 2*K multiply-adds per output at the int8 rate
        nbytes = xq.numel() + mod.wq.numel() + 8 * cout + got.numel() * got.element_size()
        ops = 2.0 * got.numel() * k * k * cin
        bms, by = bound(nbytes, ops, "int8")
        r["bound_ms"] += bms
        r["bytes_ms"] += bound(nbytes)[0]
        r["ops_ms"] += ops / PEAK_OPS_PER_S["int8"] * 1e3
        # the network launches this shape per_forward[key] times a forward
        n_fwd = per_forward[key]
        r["launches_per_forward"] += n_fwd
        r["weighted_graph_ms"] += n_fwd * gms
        r["weighted_bound_ms"] += n_fwd * bms
        if name == "qconv1x1" and r["library_ms"] is not None:
            r["library_ms"] += lib
        calls[name].append((run, plain, n_fwd))
        out = "float" if float_out else "int8"
        plan = qconv_plan(got.shape[0] * got.shape[2] * got.shape[3], cout, k * k * cin, cin,
                          mod.wq.shape[1])
        print(f"[kernels] {name} B={B} {k}x{k}/s{s} {cin}->{cout} @{h}x{w} {act} -> {out} x{n_fwd} "
              f"a forward, tile {plan.bm}x{plan.bn} {'gather' if plan.gather else 'cp.async'}: "
              f"bit-identical; kernel device {gms:.4f} ms (graph replay), events {ms:.4f} ms, "
              f"plain {pms:.4f} ms; bound {bms:.4f} ms ({by}), {100 * bms / gms:.1f}% of bound, "
              f"{ops / gms / 1e9:.1f} TOP/s | {card}", flush=True)
    for name, r in res.items():
        if not r["shapes"]:
            raise AssertionError(f"{name}: no conv of the int8 network runs on it")
        with torch.inference_mode():
            r["device_ms"] = device_profile(lambda c=calls[name]: [run() for run, _, _ in c],
                                            iters=3)[0]
            r["plain_device_ms"] = device_profile(lambda c=calls[name]: [p() for _, p, _ in c],
                                                  iters=2)[0]
            r["weighted_device_ms"] = device_profile(
                lambda c=calls[name]: [run() for run, _, n in c for _ in range(n)], iters=3)[0]
        r["at"] = f"B={B} @640, sum over the {r['shapes']} distinct shapes of the int8 network"
        r["bound_by"] = "operations" if r.pop("ops_ms") > r.pop("bytes_ms") else "bytes"
        r["lost_per_forward_ms"] = r["weighted_graph_ms"] - r["weighted_bound_ms"]
        print(f"[times] {name} B={B}, all {r['shapes']} shapes once: kernel device "
              f"{fmt_ms(r['device_ms'])} (graph replay {r['graph_ms']:.4f} ms, events "
              f"{r['ms']:.4f} ms), plain {r['plain_ms']:.4f} ms (device "
              f"{fmt_ms(r['plain_device_ms'])}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"library {fmt_ms(r['library_ms'])} | {card}", flush=True)
        print(f"[times] {name} B={B}, a forward ({r['launches_per_forward']} launches over "
              f"{r['shapes']} shapes): kernel device {fmt_ms(r['weighted_device_ms'])} (graph "
              f"replay {r['weighted_graph_ms']:.4f} ms), bound {r['weighted_bound_ms']:.4f} ms, "
              f"lost {r['lost_per_forward_ms']:.4f} ms | {card}", flush=True)
    return res


def phase_int8_slice(qmodel, requests, device, card: str) -> dict:
    """The int8 model through ``YOLOv5.__call__`` in both dtypes and configs,
    then the card against the CPU run of the port on one frame."""
    import copy

    import torch

    from yolort_tpu_torch import YOLOv5
    from yolort_tpu_torch.models.transform import letterbox_batch, make_plan
    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    models = {dt: YOLOv5(model=qmodel, device=device, dtype=dt) for dt in (torch.float32, torch.bfloat16)}
    reset_launch_counts()
    outs = {}
    for dt, m in models.items():
        for name, cfg in (("eval", EVAL), ("serving", SERVING)):
            qmodel.score_thresh, qmodel.pre_nms_topk = cfg["score_thresh"], cfg["pre_nms_topk"]
            outs[(dt, name)] = [m(req) for req in requests]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    print(f"[int8] int8 path launches: {launches}", flush=True)
    on_path = ROUTE_KERNELS[DEFAULT_ROUTE] + ("qconv1x1", "qconv_kxk")
    for kname, n in launches.items():
        if kname in on_path and n <= 0:
            raise AssertionError(f"kernel {kname} was not launched on the int8 path")
        if kname not in on_path and n:
            raise AssertionError(f"kernel {kname} launched on the int8 path, which does not run it")
    for (dt, name), res in outs.items():
        dets = [d for req in res for d in req]
        for d in dets:
            if not len(d["boxes"]):
                raise AssertionError(f"int8 {dt} {name}: an image has no detections")
            if not (np.isfinite(d["boxes"]).all() and np.isfinite(d["scores"]).all()):
                raise AssertionError(f"int8 {dt} {name}: non-finite detections")
            if d["boxes"].shape[1] != 4 or not ((d["labels"] >= 0) & (d["labels"] < 80)).all():
                raise AssertionError(f"int8 {dt} {name}: malformed detections")
        print(f"[int8] {str(dt):>14} {name:>7}: detections/img {[len(d['boxes']) for d in dets]}",
              flush=True)

    # one request (4x480x640), serving config, on each other route: its
    # kernels launch on the int8 head outputs and it serves the default
    # route's detections
    qmodel.score_thresh, qmodel.pre_nms_topk = SERVING["score_thresh"], SERVING["pre_nms_topk"]
    for route in ROUTES[1:]:
        qmodel.row_gather = route
        reset_launch_counts()
        for dt, m in models.items():
            for d, d0 in zip(m(requests[1]), outs[(dt, "serving")][1]):
                if not all(np.array_equal(d[key], d0[key]) for key in ("boxes", "scores", "labels")):
                    raise AssertionError(f"int8 {route} {dt} serving: detections differ from the "
                                         f"default route's")
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in KERNELS}
        want = ROUTE_KERNELS[route] + ("qconv1x1", "qconv_kxk")
        for kname, n in counts.items():
            if (kname in want) != (n > 0):
                raise AssertionError(f"int8 route {route}: kernel {kname} launched {n} times")
        print(f"[int8] route {route}, serving, 4x480x640 in both dtypes: launches {counts}; "
              f"detections equal to the default route's", flush=True)
    qmodel.row_gather = DEFAULT_ROUTE

    # the card's int8 network against the CPU run of the port (plain
    # versions) on one 480x640 frame, same float32 canvas
    raw = torch.from_numpy(np.stack(frames(13, 1, 480, 640)))
    canvas = letterbox_batch(raw.float() / 255.0, make_plan([tuple(raw.shape[1:3])])[0])
    cpu_model = copy.deepcopy(qmodel).cpu()
    with torch.inference_mode():
        feats_gpu = qmodel.features(canvas.to(device))
        feats_cpu = cpu_model.features(canvas)
        heads_gpu = qmodel.head(feats_gpu)
        heads_cpu = cpu_model.head(feats_cpu)
    flips = []
    for fg, fc in zip(feats_gpu, feats_cpu):
        d = (fg.q.cpu().int() - fc.q.int()).abs()
        flips.append((int((d > 0).sum()), d.numel(), int(d.max())))
    head_err = max((hg.cpu() - hc).abs().max().item() for hg, hc in zip(heads_gpu, heads_cpu))
    head_max = max(hc.abs().max().item() for hc in heads_cpu)
    print(f"[int8] card vs CPU, 1x480x640 float32: PAN int8 features differing (count, of, max levels) "
          f"{flips}; head logits max abs diff {head_err:.3e} (max |logit| {head_max:.3f})", flush=True)
    # bound: the int8 activations identical but where the card's and the
    # CPU's sigmoid differ by an ulp at a rounding boundary (a one-level
    # flip, rarely more after it propagates), and logits within 1e-3 of the
    # largest logit
    for n, total, mx in flips:
        if n > 1e-3 * total or mx > 2:
            raise AssertionError(f"int8 card vs CPU: {n}/{total} feature values differ, up to {mx} levels")
    if head_err > 1e-3 * head_max:
        raise AssertionError(f"int8 card vs CPU: head logits differ by {head_err} (max |logit| {head_max})")

    unpaired = 0
    for dt in (torch.float32, torch.bfloat16):
        with torch.inference_mode():
            heads = qmodel.head_outputs(canvas.to(device, dt))
        for name, cfg in (("eval", EVAL), ("serving", SERVING)):
            qmodel.score_thresh, qmodel.pre_nms_topk = cfg["score_thresh"], cfg["pre_nms_topk"]
            with torch.inference_mode():
                det_gpu = qmodel.postprocess(heads)
                det_cpu = qmodel.postprocess([h.cpu() for h in heads])
            un = pair_detections(det_gpu, det_cpu, f"int8 {dt} {name}")
            unpaired += un
            print(f"[int8] card vs CPU postprocess, int8 {dt} {name} (480, 640): counts equal, "
                  f"{un} unpaired", flush=True)
    return dict(launches=launches, models=models, unpaired=unpaired)


def phase_throughput(models, card: str, label: str) -> None:
    """Images/s at batch 32 in the serving config, then where a batch's
    time goes: network and postprocess by CUDA events, device busy time,
    the heaviest kernels and the hand-written kernels' share by
    torch.profiler."""
    import torch

    from yolort_tpu_torch.models.transform import letterbox_batch, make_plan

    batch = frames(20, 32, 640, 640)
    for dt, m in models.items():
        m.model.score_thresh, m.model.pre_nms_topk = SERVING["score_thresh"], SERVING["pre_nms_topk"]
        m(batch)
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m(batch)
            ts.append(time.perf_counter() - t0)
        sec = float(np.median(ts))
        print(f"[times] yolov5s {label} serving {dt} batch 32 @640x640 uint8 -> detections: "
              f"{32 / sec:.1f} images/s ({sec * 1e3:.2f} ms/batch, host clock, median of 5) | {card}",
              flush=True)

        yolo = m.model
        x = torch.from_numpy(np.stack(batch)).to(m.device)
        plan = make_plan([tuple(x.shape[1:3])])[0]
        with torch.inference_mode():
            def net():
                return yolo.head_outputs(letterbox_batch(x.to(dt) * (1.0 / 255.0), plan))

            heads = net()
            net_ms = median_ms(net, 5, 3)
            post_ms = median_ms(lambda: yolo.postprocess(heads), 5, 3)
        busy, rows = device_profile(lambda: m(batch), iters=3)
        top = ", ".join(f"{name[:48]} {ms:.3f}" for name, ms in rows[:6])
        print(f"[breakdown] {label} {dt} batch 32: letterbox+network {net_ms:.2f} ms, postprocess "
              f"{post_ms:.2f} ms (CUDA events); whole call device-busy {fmt_ms(busy)} of "
              f"{sec * 1e3:.2f} ms wall | {card}", flush=True)
        print(f"[breakdown] {label} {dt} heaviest kernels (ms per call): {top}", flush=True)
        names = ("nms_mask_kernel", "bisect_count", "row_fetch", "qconv_kernel",
                 "cells_stage1", "lookup_fetch", "select_extract", "compact_place")
        ours = {n: ms for n, ms in rows if any(k in n for k in names)}
        qms = sum(ms for n, ms in ours.items() if "qconv_kernel" in n)
        share = f"{100 * qms / busy:.1f}%" if busy else "not measured"
        by_kernel = {}
        for n, ms in ours.items():
            short = next(k for k in names if k in n)
            by_kernel[short] = round(by_kernel.get(short, 0.0) + ms, 4)
        print(f"[breakdown] {label} {dt} hand-written kernels (ms per call): {by_kernel}; "
              f"qconv kernels {qms:.3f} ms, {share} of device-busy", flush=True)


def phase_route_times(models, card: str) -> dict:
    """The postprocess's time per route at batch 32 @640 on the same head
    outputs, both configs, both dtypes: CUDA events around back-to-back
    calls (host gaps included) and the profiler's device time."""
    import torch

    from yolort_tpu_torch.models.transform import letterbox_batch, make_plan

    batch = frames(20, 32, 640, 640)
    out = {}
    for dt, m in models.items():
        yolo = m.model
        x = torch.from_numpy(np.stack(batch)).to(m.device)
        plan = make_plan([tuple(x.shape[1:3])])[0]
        with torch.inference_mode():
            heads = yolo.head_outputs(letterbox_batch(x.to(dt) * (1.0 / 255.0), plan))
            for name, cfg in (("eval", EVAL), ("serving", SERVING)):
                yolo.score_thresh, yolo.pre_nms_topk = cfg["score_thresh"], cfg["pre_nms_topk"]
                line = []
                for route in ROUTES:
                    yolo.row_gather = route
                    ev = median_ms(lambda: yolo.postprocess(heads), 5, 3)
                    dev = device_profile(lambda: yolo.postprocess(heads), iters=3)[0]
                    out[(str(dt), name, route)] = (ev, dev)
                    line.append(f"{route} {ev:.3f} ms (device {fmt_ms(dev)})")
                yolo.row_gather = DEFAULT_ROUTE
                print(f"[times] postprocess {dt} {name} batch 32 @640 by route: {'; '.join(line)} "
                      f"| {card}", flush=True)
        yolo.score_thresh, yolo.pre_nms_topk = SERVING["score_thresh"], SERVING["pre_nms_topk"]
    return out


def phase_entry_points() -> dict:
    """Both timing entry points' main at batch 128, each with the launch
    counts set to 0 just before it and read just after; the kernel each
    runs must have launched."""
    import importlib

    import torch

    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    launches = {}
    for name in ENTRY_POINTS:
        module = importlib.import_module(f"yolort_tpu_torch.experiments.{name}")
        torch.cuda.empty_cache()
        reset_launch_counts()
        t0 = time.perf_counter()
        rc = module.main(["--batch", "128"])
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in KERNELS}
        if rc != 0 or counts[ENTRY_POINTS[name]] <= 0:
            raise AssertionError(f"{name}: rc {rc}, {ENTRY_POINTS[name]} launched "
                                 f"{counts[ENTRY_POINTS[name]]} times")
        print(f"[entry] python -m yolort_tpu_torch.experiments.{name} --batch 128: rc {rc} in "
              f"{time.perf_counter() - t0:.1f} s, launches { {k: n for k, n in counts.items() if n} }",
              flush=True)
        launches[name] = counts
    torch.cuda.empty_cache()
    return launches


def main() -> int:
    import torch

    card = phase_device()
    import yolort_tpu_torch  # noqa: F401  (fails outside a checkout)

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()

    def done(phase: str) -> None:
        print(f"[wall] {phase} done at {time.perf_counter() - t0:.1f} s", flush=True)

    phase_build()
    done("build")
    res = phase_kernels(device, card)
    res.update(phase_postprocess_kernels(device, card))
    res.update(phase_sweep_kernels(device, card))
    done("kernels")
    sl = phase_slice(device, card)
    done("slice")
    batch = frames(20, 32, 640, 640)
    qmodel = build_int8(device, sl["requests"], batch)
    res.update(phase_qconv_kernels(qmodel, batch, device, card))
    done("int8 build and qconv kernels")
    q8 = phase_int8_slice(qmodel, sl["requests"], device, card)
    done("int8 slice")
    phase_throughput(sl["models"], card, "float")
    phase_throughput(q8["models"], card, "int8")
    phase_route_times(sl["models"], card)
    done("times")
    paths = {"float": sl["launches"], "int8": q8["launches"], **phase_entry_points()}
    done("entry points")
    kernels = []
    for name, (source, replaces) in TPU_KERNELS.items():
        by_path = {path: counts[name] for path, counts in paths.items()}
        per_batch = {route: n[name] for route, n in sl["per_batch"].items() if name in n}
        r = {k: v for k, v in res[name].items() if k != "shapes"}
        kernels.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                            launches=sum(by_path.values()), launches_by_path=by_path,
                            launches_per_batch_by_route=per_batch, **r))
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
