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
     first three timed at both tables, compact_place with the device
     kernels of one call counted from the profiler's rows (must be 1: the
     kernel writes the empty tail itself), and row_fetch there on the main
     path's own indices (select_topk_threshold's phys); row_fetch_p at every
     swept geometry against its plain version at both sweep shapes
     (experiments/fetch_block_sweep.py), batch 8, and timed there at
     row_fetch's own geometry (row_fetch_geometry); fused_cells_stage1 (its tile plan
     printed) at 8x640 with and without special logits, at 4x480x640 and
     at batch 32, in both dtypes, timed at batch 8 and 32 beside its
     bound, its plain version and torch.cat alone; results must be
     bit-identical (NaN positions compared as NaN); compact_select must
     equal select_topk_threshold on the same scores;
     fused_cells_stage1 and bisect_count also at the yolov5s6 @1280 shapes:
     four levels at 1280x1280 and on the 768x1280 canvas of a 720p frame,
     and the stage-1 tables (797,128) and (479,128) at k = 4104 and 520,
     timed at batch 8 warm and with the L2 flushed, beside their bounds;
     row_fetch timed at both stage-2 tables, warm and cold, with random
     and with main-path indices;
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
     on one 480x640 frame within the bound printed there, and conv by
     conv (int8_witness: each conv given the card's own input, the kernel
     bit-identical to its plain version on the card, and the CPU's output
     equal but for one-level flips whose exact value lies within 8 float32
     ulps of a rounding boundary);
  5b. flatten and decoded paths: on phase 4's models and requests, the
     classes_per_anchor (= CPA) flatten path through YOLOv5.__call__ and
     batched_postprocess of YOLO.decode, both dtypes and configs, once per
     route: exactly FLATTEN_KERNELS a batch (bisect_count 2, the route's
     fetch kernel 2, nms_mask 1), each route's detections equal to the
     default route's, the card's postprocess paired with the CPU's on
     every route, each path's postprocess time per route;
  5c. fixed_shape: 720x1280, 480x640 and 1080x1920 frames served as one
     batch on a 640x640 canvas (YOLOv5(fixed_shape=...)), both dtypes and
     configs: the default route's kernels once a batch, canvas slices
     equal to each frame's own canvas, the batch's postprocess equal to
     each image's own, each image paired with its frame served alone and
     the card's postprocess with the CPU's; predict_rich and the hub
     file's yolov5s (torch.hub.load, source='local') on the card;
  5d. r3.1 int8: yolov5s r3.1 (Hardswish) at full width @640 on the
     weights of a fabricated r3.1 checkpoint, through phase 5: the qconv
     kernels with Hardswish at every conv shape, and with LeakyReLU and
     SiLU at the same shapes, bit-identical and timed; int8 serving,
     routes, card against CPU end to end and conv by conv;
  6. p6: phase 4 for yolov5s6 at full width @1280 (stride-64 rounding) on
     8x720x1280, 2x1080x1920 and 1x1280x1280 frames, the card paired with
     the CPU on the 1280x1280 request; then yolov5s6 in int8 on its seeded
     weights, held against the CPU conv by conv (int8_witness), with the
     spread of one flip on the card beside the card-vs-CPU counts at the
     PAN outputs (in this network one flip reaches thousands of values,
     so its end-to-end comparison is made conv by conv); then phase 5 for
     yolov5s6 on the weights of the fabricated yolov5s6 checkpoint of
     phase 7: calibrated on 1280x1280 frames, the qconv kernels at every
     conv shape at batch 4 @1280, int8 serving in both dtypes and configs,
     card against CPU end to end and conv by conv;
  7. checkpoints: ultralytics-layout checkpoints fabricated by
     tests/torch_fixture.make_checkpoint (yolov5s6 at full width @1280;
     r3.1, r4.0 and TAN at nano width @640) loaded by
     YOLOv5.load_from_yolov5 on the card in both dtypes and on the CPU:
     served through the default route's kernels, the card's decode within
     the JAX test's tolerance of the fixture's torch oracle, its head
     outputs within 1e-3 of the largest logit of the CPU's, its
     postprocess of them, put on a 1/64 grid, paired with the CPU's;
  8. times: each kernel's time beside its plain version's, its bound and
     the time of a PyTorch call that computes the same function where
     there is one (the stage-2 row kernels, whose table and stores fit in
     L2, also cold, with the L2 flushed before each launch, and their
     share of the bound taken of that time); images/s of the float and int8 slices at batch 32; the
     postprocess's time per route at batch 32 in both configs and dtypes;
     yolov5s6 serving at batch 8 @1280 on each route (images/s, device
     busy); then the two timing entry points at batch 128 (python -m
     yolort_tpu_torch.experiments.lookup_kernel_variants and
     .fetch_block_sweep: each checks its kernel against the plain version
     and prints its times), each with the launch counts read around it.
  9. train (run before 8): yolov5s r6.0 at full width @640, f32, in its
     train form (YOLO.init_train), on an in-memory synthetic COCO-style
     set of 32 480x640 frames: (a) one train step on the card against the
     CPU from the same params on one 2-image batch, TF32 off (loss terms,
     every gradient leaf and every param after the step within TRAIN_TOL;
     the worst leaf printed); (b) ten steps on one repeated batch of 8,
     every loss finite and the last total below the first, steps 3-10
     timed with CUDA events (step ms, images/s, max_memory_allocated,
     each beside the card's name and power limit); (c) trainer.fit for one
     epoch with the EMA and a checkpoint, validated on 8 frames: the
     evaluation launches exactly DEFAULT_PER_BATCH a batch and nothing
     else, and the COCO metrics are finite; (d) the train state saved and
     loaded on the card gives back params, momentum buffers, step and
     schedule count bit for bit.
 10. zoo (run after 7): (a) yolo_lite (yolov5_mobilenet_v3_small_fpn, 80
     classes, seeded) and (b) yolov5s assembled from its yaml config
     (YAMLDetectionModel), each at full width @640 through YOLOv5(model=...)
     (yolo_lite with stride-64 rounding) as phase 4 serves yolov5s: every
     route's detections equal to the default's, the default route exactly
     fused_cells_stage1 1, bisect_count 2, row_fetch 1 and nms_mask 1 a
     batch (yolo_lite's four levels), the card paired with the CPU on the
     4x480x640 request, and each one's serving of 8 640x640 frames timed
     on every route (images/s, device busy, postprocess per route); then
     the non-standard checkpoint of
     tests/torch_fixture (an extra C3) through load_yaml_from_ultralytics
     on the card in both dtypes, its decode against the fixture's torch
     oracle; (c) Ensemble of yolov5s + yolov5m (50,400 pooled anchors) and
     tta_inference of yolov5s (55,755) on 8 letterboxed 640x640 canvases,
     both dtypes and configs, every route: exactly bisect_count 2, the
     route's fetch kernel 2, nms_mask 1 a batch, each route's Detections
     equal to the default's, the card paired with the CPU on 2 images,
     the batch time (CUDA events), device busy and the postprocess per
     route; phase 3 checks fused_cells_stage1 at yolo_lite's levels and
     bisect_count at the stage-1 tables (200,128), (394,128) and
     (436,128) the same way as the P6 shapes.
 11. int8, the rest (run after 10): yolo_lite (80 classes, seeded, head
     biases shifted) calibrated on the card and quantized under the
     default recipe (41 convs) and under min_reduce=1 (61: every
     depth-wise conv on qconv_grouped, the ReLU convs), each finalized;
     (a) every distinct quantized conv shape of the min_reduce=1 network
     @640 at batch 8, on its own activations, and DWConv(96, 64, 5) and a
     C3Ghost's cheap halves on seeded int8: each qconv kernel against its
     plain version in int8, float32 and bfloat16 out, outputs poisoned,
     bit for bit, each shape timed beside its bound; (b) both served
     through YOLOv5(model=..., size_divisible=64) on phase 4's requests in
     both dtypes and configs on every route (every route equal to the
     default, the qconv kernels exactly the model's convs a batch, the
     postprocess as phase 10), paired with the CPU, held against the CPU
     conv by conv (int8_witness), images/s and device busy; (c) the int8
     AP harness (utils/quant_probe.py): the nano scene detector trained
     1000 steps with TF32 off and deterministic algorithms from
     quant_probe.SCENE_SEED, then int8_ap_report, under the bounds of
     tests/test_int8_ap_delta.py (float AP >= 0.7, all-int8 AP >= half of
     it, delta <= 0.05).
The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels as JSON, with each kernel's launches by path (float, int8,
cpa, decoded, fixed_shape, r31_int8, p6, p6_int8, checkpoint, train_eval,
zoo_lite, zoo_yaml, ensemble, tta, int8_lite, int8_lite_grouped, int8_ap
and the two entry points).  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import sys
import tempfile
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
    # grouped int8 convs: XLA's s8 conv in the JAX package (ops/blocks.py
    # _conv_int8), beside the 3x3 Pallas kernel of row 8
    "qconv_grouped": ("yolort_tpu_torch/csrc/qconv.cu", "yolort_tpu/ops/pallas/qconv.py:238"),
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
    timed = {}
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
            # timed at the eval (2565,128) k=4096 and serving (325,128)
            # k=512 tables, warm and with the L2 flushed
            ms = median_ms(lambda: row_fetch(tab, idx))
            pms = median_ms(lambda: row_fetch_reference(tab, idx))
            dev = device_profile(lambda: row_fetch(tab, idx))[0]
            pdev = device_profile(lambda: row_fetch_reference(tab, idx))[0]
            gidx = idx.long().clamp(0, m - 1)[..., None].expand(-1, -1, w)
            lib = median_ms(lambda: torch.gather(tab, 1, gidx))
            bms, bby = bound(B * k * 4 + distinct_rows(idx, m) * w * 4 + B * k * w * 4)
            cold = cold_ms(lambda: row_fetch(tab, idx))
            share = bms / cold if cold else None
            print(f"[times] row_fetch B={B} ({m},{w}) f32 k={k}: kernel {ms:.4f} ms (device "
                  f"{fmt_ms(dev)}, cold L2 {fmt_ms(cold)}, {fmt_share(share)} of bound), plain "
                  f"{pms:.4f} ms (device {fmt_ms(pdev)}), torch.gather {lib:.4f} ms, bound "
                  f"{bms:.5f} ms ({bby}) | {card}", flush=True)
            timed[m] = dict(
                ms=ms, plain_ms=pms, device_ms=dev, plain_device_ms=pdev, cold_ms=cold,
                bound_ms=bms, bound_by=bby, device_share_of_bound=share, library_ms=lib,
                library_call="torch.gather (clamped indices)", at=f"B={B}, ({m},{w}) f32, k={k}")
    res["row_fetch"] = dict(**timed[2565], others=[timed[325]])
    res["row_fetch"]["max_abs_err"] = err
    return res


def phase_sweep_kernels(device, card: str) -> dict:
    """row_fetch_p at every swept geometry against its plain version at
    both sweep shapes, batch 8, bit for bit; then timed at row_fetch's own
    geometry (row_fetch_geometry) at each beside the plain version,
    torch.gather and the bound."""
    from yolort_tpu_torch.experiments import fetch_block_sweep as sweep
    from yolort_tpu_torch.ops.cuda.lookup_kernel import row_fetch_geometry

    err, out = 0.0, {}
    for name, (tab, idx) in sweep.make_inputs(B, device, seed=50).items():
        label = sweep.LABELS[name]
        err = max(err, sweep.check(tab, idx, label=f"B={B} {label}"))
        print(f"[kernels] row_fetch_p B={B} {label}: all {len(sweep.GEOMETRIES)} geometries "
              f"bit-identical", flush=True)
        g = row_fetch_geometry(tab.shape[2] * tab.element_size(), *idx.shape)
        r = sweep.measure(tab, idx, card, geometries=(g,), label=label, tag="[times] row_fetch_p")
        bms, bby = r["bound"]
        cold = r[g]["cold_ms"]
        out[name] = dict(ms=r[g]["ms"], device_ms=r[g]["device_ms"], cold_ms=cold,
                         plain_ms=r["plain"]["ms"], plain_device_ms=r["plain"]["device_ms"],
                         bound_ms=bms, bound_by=bby, device_share_of_bound=bms / cold if cold else None,
                         library_ms=r["library"]["ms"], library_device_ms=r["library"]["device_ms"],
                         geometry=g)
    return {"row_fetch_p": dict(
        **out["cells"], library_call="torch.gather (clamped indices)", max_abs_err=err,
        stage2=out["stage2"], at=f"B={B}, {sweep.LABELS['cells']}, row_fetch's geometry "
                                f"{out['cells']['geometry']}; stage2: {sweep.LABELS['stage2']}")}


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
        fused_cells_stage1_reference, lookup_fetch, lookup_fetch_reference, row_fetch,
        row_fetch_reference, select_extract, select_extract_reference,
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
    main_path = []  # row_fetch on select_topk_threshold's own phys
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
        # row_fetch on the indices the default route hands it: phys is
        # select_topk_threshold's (the chunk of each slot, from the offsets)
        ph32 = phys.to(torch.int32).contiguous()
        if not same_bits(row_fetch(tab, ph32), row_fetch_reference(tab, ph32)):
            raise AssertionError(f"row_fetch B={B} ({m},128) k={k} main-path indices: differs from "
                                 f"the plain version")
        runs["row_fetch"] = (lambda: row_fetch(tab, ph32), lambda: row_fetch_reference(tab, ph32),
                             "torch.gather (clamped indices)", lambda: torch.gather(tab, 1, gidx),
                             B * k * 4 + distinct_rows(phys, m) * 512 + B * k * 512)
        for kname, (run, plain, pname, pcall, nbytes) in runs.items():
            ms, pms = median_ms(run), median_ms(plain, 5)
            dev, rows = device_profile(run)
            pdev = device_profile(plain)[0]
            if kname == "compact_place" and len(rows) != 1:
                raise AssertionError(f"compact_place B={B} ({m},128) k={k}: {len(rows)} device "
                                     f"kernels a call ({[n for n, _ in rows]}), want 1")
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
                     library_call=None, kernels_per_call=len(rows),
                     nearest_partial=pname, nearest_partial_ms=partial,
                     at=f"B={B}, ({m},128), k={k}, random table")
            if kname == "row_fetch":
                r.update(library_ms=partial, library_call=pname, nearest_partial=None,
                         nearest_partial_ms=None, at=f"{r['at']}, main-path indices")
                main_path.append(r)
            elif m == 2565:
                res[kname] = r
            else:
                serving[kname] = r
    for kname, e in errs.items():
        res[kname]["max_abs_err"] = e
    for kname, r in serving.items():
        res[kname]["others"] = [r]
    res["row_fetch"] = {"main_path": main_path}
    return res


P6_1280 = ((160, 160), (80, 80), (40, 40), (20, 20))  # yolov5s6 head levels @1280x1280
P6_768 = ((96, 160), (48, 80), (24, 40), (12, 20))     # @768x1280, a 720p or 1080p frame


def check_stage1_kernels(device, card: str, label: str, level_sets, table_rows) -> tuple:
    """fused_cells_stage1 at each of ``level_sets`` (head level sizes, 255
    channels) and bisect_count at each stage-1 table (m,128) of
    ``table_rows`` at k = 4104 (eval) and 520 (serving), against their
    plain versions bit for bit, in both dtypes, batch 8 (bisect_count
    also batch 1); timed at batch 8, warm and with the L2 flushed,
    beside their bounds.  Returns (cells timings, tables timings, max abs
    errors)."""
    import torch

    from yolort_tpu_torch.ops.cuda import (
        bisect_count, bisect_count_reference, fused_cells_stage1, fused_cells_stage1_reference,
    )
    from yolort_tpu_torch.ops.cuda.lookup_kernel import bisect_plan

    cells, tables = {}, {}
    err = {"fused_cells_stage1": 0.0, "bisect_count": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        for sizes in level_sets:
            geometry = "+".join(f"{h}x{w}" for h, w in sizes)
            for special in (True, False):
                levels = logit_levels(50 + special, B, device, dtype, special, sizes)
                got = fused_cells_stage1(levels, 3, 85)
                ref = fused_cells_stage1_reference(levels, 3, 85)
                torch.cuda.synchronize()
                for a, b, what in zip(got, ref, ("cells", "obj_max", "cls_max")):
                    if not same_bits(a, b):
                        raise AssertionError(f"fused_cells_stage1 {label} {dtype} B={B} "
                                             f"{geometry} special={special}: {what} differs")
                    err["fused_cells_stage1"] = max(err["fused_cells_stage1"], abs_err(a, b))
                print(f"[{label} kernels] fused_cells_stage1 {dtype} B={B} {geometry} C=255"
                      f"{' with NaN/inf/below-floor logits' if special else ''}: equal", flush=True)
                del got, ref
                if special:
                    continue
                run = lambda lv=levels: fused_cells_stage1(lv, 3, 85)  # noqa: E731
                plain = lambda lv=levels: fused_cells_stage1_reference(lv, 3, 85)  # noqa: E731
                flat = [lv.reshape(B, -1, 255) for lv in levels]
                cat = lambda flat=flat: torch.cat(flat, dim=1)  # noqa: E731
                dev, cold = device_profile(run)[0], cold_ms(run)
                pdev, cdev = device_profile(plain)[0], device_profile(cat)[0]
                n_cells = sum(h * w for h, w in sizes)
                esize = levels[0].element_size()
                bms, bby = bound(2 * B * n_cells * 255 * esize + 2 * B * n_cells * 3 * esize)
                share = bms / cold if cold else None
                print(f"[times] fused_cells_stage1 {label} B={B} {geometry} {dtype}: device "
                      f"{fmt_ms(dev)}, cold L2 {fmt_ms(cold)} ({fmt_share(share)} of bound), plain "
                      f"device {fmt_ms(pdev)}, torch.cat alone device {fmt_ms(cdev)}, bound "
                      f"{bms:.4f} ms ({bby}) | {card}", flush=True)
                cells[f"{geometry} {str(dtype).split('.')[-1]}"] = dict(
                    device_ms=dev, cold_ms=cold, plain_device_ms=pdev, bound_ms=bms, bound_by=bby,
                    device_share_of_bound=share, nearest_partial_device_ms=cdev)
                del levels, flat
    for m in table_rows:
        for k in (4104, 520):
            for bsz in (1, B):
                tab = score_table(60 + m + k + bsz, bsz, m, device)
                got = bisect_count(tab, k, 0)
                ref = bisect_count_reference(tab, k, 0)
                for a, b in zip(got, ref):
                    if not torch.equal(a, b):
                        raise AssertionError(f"bisect_count {label} stage 1 B={bsz} ({m},128) "
                                             f"k={k}: differs from the plain version")
                    err["bisect_count"] = max(err["bisect_count"],
                                              (a.double() - b.double()).abs().max().item())
                plan = bisect_plan(bsz, m)
                print(f"[{label} kernels] bisect_count stage 1 B={bsz} ({m},128) k={k}: equal, "
                      f"cluster {plan.cluster} {'resident' if plan.resident else 'streamed'}",
                      flush=True)
                if bsz != B:
                    continue
                run = lambda tab=tab, k=k: bisect_count(tab, k, 0)  # noqa: E731
                flat = tab.reshape(B, -1)
                dev, cold = device_profile(run)[0], cold_ms(run)
                tdev = device_profile(lambda flat=flat, k=k: torch.topk(flat, k, dim=1))[0]
                bms, bby = bound(B * m * 128 * 4 + B * 4 + 2 * B * m * 4)
                share = bms / cold if cold else None
                print(f"[times] bisect_count {label} stage 1 B={B} ({m},128) k={k}: device "
                      f"{fmt_ms(dev)}, cold L2 {fmt_ms(cold)} ({fmt_share(share)} of bound), "
                      f"torch.topk device {fmt_ms(tdev)}, bound {bms:.5f} ms ({bby}) | {card}",
                      flush=True)
                tables[f"({m},128) k={k}"] = dict(
                    device_ms=dev, cold_ms=cold, bound_ms=bms, bound_by=bby,
                    device_share_of_bound=share, topk_device_ms=tdev, cluster=plan.cluster,
                    resident=plan.resident)
    return cells, tables, err


def phase_p6_kernels(device, card: str) -> dict:
    """``check_stage1_kernels`` at the shapes yolov5s6 gives the kernels
    @1280: four levels at 1280x1280 and on the 768x1280 canvas, and the
    stage-1 tables (797,128) and (479,128)."""
    cells, tables, err = check_stage1_kernels(device, card, "p6", (P6_1280, P6_768), (797, 479))
    return {"fused_cells_stage1": dict(p6=cells, p6_max_abs_err=err["fused_cells_stage1"]),
            "bisect_count": dict(p6_stage1=tables, p6_max_abs_err=err["bisect_count"])}


def frames(seed: int, n: int, h: int, w: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for _ in range(n)]


def calibrate_candidate_density(m, requests, target: int = 120, margin: float = 0.5) -> float:
    """Head-bias shift that gives every image at least ``target`` pairs with
    score > 0.25: seeded random weights keep scores near 1e-4, which would
    leave the selection and NMS kernels with no work.  Bisects the shift
    on ``YOLOv5`` ``m``'s own logits of the requests' frames, as
    bench.calibrate_candidate_density does, then adds ``margin``: random
    weights make the count a cliff in the shift, and the margin keeps a
    bias rounded to bfloat16 on the busy side of it."""
    import torch

    yolo = m.model
    logits = []
    for raw_u8 in requests:
        x = torch.from_numpy(np.stack(raw_u8)).to(m.device)
        with torch.inference_mode():
            outs = yolo.head_outputs(m.canvas(x)[0])
        logits.append(torch.cat([o.reshape(o.shape[0], -1, 5 + yolo.num_classes).float()
                                 for o in outs], dim=1))

    def count_at(d):
        counts = []
        for lg in logits:
            s = torch.sigmoid(lg[..., 4:5] + d) * torch.sigmoid(lg[..., 5:] + d)
            counts.append(int((s > 0.25).sum(dim=(1, 2)).min()))
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


def serve_routes(models, requests, label: str, convs=None) -> dict:
    """``YOLOv5.__call__`` of each model (by dtype) on the requests in both
    configs, once per route of ROUTES, each route's launch counts set to 0
    just before and read just after: every kernel of a route must launch
    (the default route exactly DEFAULT_PER_BATCH a batch) and no other;
    every image must carry detections; each route must serve the default
    route's detections exactly.  ``convs`` (an int8 model's qconv kernel ->
    launches a forward, ``conv_launches``) are launched exactly that many
    times a batch on every route."""
    import torch

    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    convs = convs or {}
    runs = [(dt, name, cfg) for dt in models for name, cfg in (("eval", EVAL), ("serving", SERVING))]
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
        print(f"[{label}] route {route}: launches over {batches} batches {counts}", flush=True)
        for kname, n in counts.items():
            on_route = kname in ROUTE_KERNELS[route] or kname in convs
            if on_route and n <= 0:
                raise AssertionError(f"{label}: kernel {kname} was not launched on route {route}")
            if not on_route and n:
                raise AssertionError(f"{label}: kernel {kname} launched on route {route}, which "
                                     f"does not run it")
            if kname in convs and n != convs[kname] * batches:
                raise AssertionError(f"{label} route {route}: {kname} launched {n} times, want "
                                     f"{convs[kname]} a batch x {batches}")
        if route == DEFAULT_ROUTE:
            want = {kname: (DEFAULT_PER_BATCH.get(kname, 0) + convs.get(kname, 0)) * batches
                    for kname in counts}
            if counts != want:
                raise AssertionError(f"{label}: default route launches {counts}, want {want}")
    for m in models.values():
        m.model.row_gather = DEFAULT_ROUTE
    for (route, dt, name), res in outs.items():
        counts = check_served(res, f"{label} {route} {dt} {name}")
        if route == DEFAULT_ROUTE:
            print(f"[{label}] {str(dt):>14} {name:>7}: detections/img {counts}", flush=True)
            continue
        base = outs[(DEFAULT_ROUTE, dt, name)]
        for req, req0 in zip(res, base):
            for d, d0 in zip(req, req0):
                if not all(np.array_equal(d[key], d0[key]) for key in ("boxes", "scores", "labels")):
                    raise AssertionError(f"{label} {route} {dt} {name}: served detections differ "
                                         f"from the default route's")
    print(f"[{label}] every route served the default route's detections exactly", flush=True)
    totals = {kname: sum(launches[r][kname] for r in ROUTES) for kname in launches[DEFAULT_ROUTE]}
    per_batch = {r: {k: n / batches for k, n in launches[r].items() if n} for r in ROUTES}
    return dict(launches=totals, per_batch=per_batch)


def pair_routes_with_cpu(models, requests, label: str, grid: int = 0) -> dict:
    """On the same head outputs, each route's Detections equal the default
    route's on the card, and the card's postprocess agrees with the CPU run
    of the port (``pair_detections``), in both dtypes and configs.  With
    ``grid`` the head outputs are put on a 1/grid grid first, the same on
    both sides, as phase 7 does for networks whose best pair scores lie
    ulps apart (the share of such near-ties is printed): the card's and
    the CPU's sigmoids, an ulp apart, reorder those."""
    import torch

    total_unpaired = {route: 0 for route in ROUTES}
    for dt, m in models.items():
        yolo = m.model
        for name, cfg in (("eval", EVAL), ("serving", SERVING)):
            yolo.score_thresh, yolo.pre_nms_topk = cfg["score_thresh"], cfg["pre_nms_topk"]
            for req in requests:
                x = torch.from_numpy(np.stack(req)).to(m.device)
                with torch.inference_mode():
                    heads = yolo.head_outputs(m.canvas(x)[0])
                    if grid:
                        print(f"[{label}] {dt} {name}: near-ties among the 4096 best pair scores "
                              f"{100 * near_tie_share(heads):.1f}% of the gaps; head outputs put "
                              f"on a 1/{grid} grid", flush=True)
                        heads = [(torch.round(h * grid) / grid).contiguous() for h in heads]
                heads_cpu = [h.cpu() for h in heads]
                base = None
                for route in ROUTES:
                    yolo.row_gather = route
                    with torch.inference_mode():
                        det_gpu = yolo.postprocess(heads)
                        det_cpu = yolo.postprocess(heads_cpu)
                    tag = f"{label} {route} {dt} {name} {tuple(x.shape[1:3])}"
                    if base is None:
                        base = det_gpu
                    elif not all(torch.equal(a, b) for a, b in zip(det_gpu, base)):
                        raise AssertionError(f"{tag}: Detections differ from the default route's")
                    un = pair_detections(det_gpu, det_cpu, tag)
                    total_unpaired[route] += un
                    print(f"[{label}] card vs CPU {tag}: counts equal, {un} unpaired"
                          f"{'' if route == DEFAULT_ROUTE else '; equal to the default route'}",
                          flush=True)
                yolo.row_gather = DEFAULT_ROUTE
    print(f"[{label}] unpaired card vs CPU by route: {total_unpaired}", flush=True)
    return total_unpaired


def build_shifted(factory, device, requests, label: str, **kwargs) -> dict:
    """The factory's model in float32 and bfloat16, seeded, its head biases
    shifted to a realistic candidate load (``calibrate_candidate_density``)."""
    import torch

    t0 = time.perf_counter()
    models = {dt: factory(device=device, dtype=dt, seed=0, **kwargs)
              for dt in (torch.float32, torch.bfloat16)}
    for dt, m in models.items():
        delta = calibrate_candidate_density(m, requests)
        shift_head_bias(m.model, delta)
        print(f"[{label}] {m.arch} {dt} built, head bias shift {delta:.4f}", flush=True)
    print(f"[{label}] models ready in {time.perf_counter() - t0:.1f} s; float32 PAN outputs' "
          f"max |value| by level {pan_absmax(models[torch.float32], requests[0])}", flush=True)
    return models


def pan_absmax(m, req) -> list:
    """Each PAN output's largest magnitude on ``YOLOv5`` ``m``'s canvas of
    a request (seeded random weights' activations vanish with depth)."""
    import torch

    x = torch.from_numpy(np.stack(req)).to(m.device)
    with torch.inference_mode():
        feats = m.model.features(m.canvas(x)[0])
    return [f"{float(f.float().abs().max()):.2e}" for f in feats]


def near_tie_share(heads, k: int = 4096) -> float:
    """The share of the gaps between neighbours among the first image's k
    best pair scores (class x obj sigmoid) that are above 0 and under 4
    float32 ulps: near-ties, which the card's and the CPU's sigmoids, an
    ulp apart, can reorder (exact ties stay tied on both)."""
    import torch

    lg = torch.cat([h[:1].reshape(1, -1, 85).float() for h in heads], dim=1)
    s = (torch.sigmoid(lg[..., 4:5]) * torch.sigmoid(lg[..., 5:])).flatten()
    top = torch.topk(s, min(k, s.numel())).values
    gaps = (top[:-1] - top[1:]) / top[1:]
    return float(((gaps > 0) & (gaps < 4 * 2.0 ** -23)).float().mean())


def phase_slice(device, card: str) -> dict:
    """yolov5s at full width @640 on three request sizes, every route."""
    import yolort_tpu_torch

    requests = [frames(10, 8, 720, 1280), frames(11, 4, 480, 640), frames(12, 1, 1080, 1920)]
    models = build_shifted(yolort_tpu_torch.yolov5s, device, requests, "slice")
    out = serve_routes(models, requests, "slice")
    unpaired = pair_routes_with_cpu(models, requests, "slice")
    return dict(**out, unpaired=unpaired, models=models, requests=requests)


P6_SIZE = (1280, 1280)


def phase_p6(device, card: str) -> dict:
    """yolov5s6 at full width @1280 (stride-64 rounding) on 8x720x1280 and
    2x1080x1920 frames (a 768x1280 canvas) and a 1280x1280 one, every
    route, the card paired with the CPU on the 1280x1280 request."""
    import yolort_tpu_torch

    requests = [frames(14, 8, 720, 1280), frames(15, 2, 1080, 1920), frames(16, 1, 1280, 1280)]
    models = build_shifted(yolort_tpu_torch.yolov5s6, device, requests, "p6", size=P6_SIZE)
    out = serve_routes(models, requests, "p6")
    unpaired = pair_routes_with_cpu(models, requests[-1:], "p6")
    return dict(**out, unpaired=unpaired, models=models, requests=requests)


def build_int8(m, device, requests, batch, label: str):
    """Float32 ``YOLOv5`` ``m`` in int8 by the bench recipe: its head biases
    shifted, calibrated on 4 batches of 2 letterboxed frames of ``batch``,
    quantized, and its scales finalized on one frame.  Returns the
    quantized YOLO."""
    import torch

    from yolort_tpu_torch.ops.blocks import Conv, Conv2dOnly
    from yolort_tpu_torch.ops.quantization import (
        calibrate_activations, finalize_scales, quantize_compute_params,
    )

    t0 = time.perf_counter()
    delta = calibrate_candidate_density(m, requests)
    shift_head_bias(m.model, delta)
    x = torch.from_numpy(np.stack(batch[:8])).to(device)
    cal = [m.canvas(x[i:i + 2])[0] for i in (0, 2, 4, 6)]
    calibrate_activations(m.model, cal)
    qmodel = quantize_compute_params(m.model)
    finalize_scales(qmodel, cal[0][:1])
    convs = [mod for mod in qmodel.modules() if isinstance(mod, (Conv, Conv2dOnly))]
    if not all(mod.quantized for mod in convs):
        raise AssertionError(f"{m.arch} int8: a conv was left in float")
    torch.cuda.synchronize()
    print(f"[{label}] {m.arch} head bias shift {delta:.4f}, calibrated on 4x2 frames "
          f"{tuple(cal[0].shape[1:3])}, {len(convs)} convs quantized, scales finalized in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return qmodel


def phase_qconv_kernels(qmodel, m, batch, bsz: int, device, card: str,
                        other_acts: tuple = ()) -> dict:
    """qconv1x1 and qconv_kxk against their plain versions at every distinct
    conv shape of the int8 network ``qmodel`` at batch ``bsz`` on the
    canvas float ``YOLOv5`` ``m`` makes of ``batch``'s frames, on the
    activations the network itself produces there, with each conv's own
    activation; each timed beside its plain version.  Each activation of
    ``other_acts`` is also held bit for bit against the plain version at
    every shape and timed there (graph replay), its sums kept under
    ``acts``."""
    import torch

    from yolort_tpu_torch.ops.blocks import Conv, Conv2dOnly, inv_scale
    from yolort_tpu_torch.ops.cuda import (
        qconv1x1, qconv1x1_reference, qconv_kxk, qconv_kxk_reference,
    )
    from yolort_tpu_torch.ops.cuda.qconv_kernel import qconv_plan

    seen, per_forward = {}, {}

    def hook(mod, inputs, output):
        x = inputs[0]
        shape = tuple((x.q if hasattr(x, "q") else x).shape)
        act = mod.act if isinstance(mod, Conv) else "none"
        key = (mod.k, mod.s, mod.pad, shape[1], mod.wq.shape[0], shape[2], shape[3], act,
               mod.os is None)
        seen.setdefault(key, (mod, x))
        per_forward[key] = per_forward.get(key, 0) + 1

    hooks = [mod.register_forward_hook(hook) for mod in qmodel.modules()
             if isinstance(mod, (Conv, Conv2dOnly))]
    x = torch.from_numpy(np.stack(batch[:bsz])).to(device)
    with torch.inference_mode():
        canvas = m.canvas(x)[0]
        qmodel.head_outputs(canvas)
    at = f"B={bsz} @{canvas.shape[1]}x{canvas.shape[2]}"
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
    for r in res.values():
        r["acts"] = {a: dict(graph_ms=0.0, weighted_graph_ms=0.0, shapes=0) for a in other_acts}
    calls = {n: [] for n in res}
    for key, (mod, xin) in sorted(seen.items()):
        k, s, pad, cin, cout, h, w, act, float_out = key
        xq, scale, bias, os, ft = mod.qconv_operands(xin)
        args = (xq, mod.wq, scale, bias)
        kw = dict(inv_out_scale=None if os is None else inv_scale(os), out_dtype=ft)
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
        others = []
        for other in other_acts:
            if other == act:
                continue
            with torch.inference_mode():
                run_o = lambda a=args, kw=kw, o=other, n=name, kk=k, ss=s, pp=pad: (  # noqa: E731
                    qconv1x1(*a, act=o, **kw) if n == "qconv1x1"
                    else qconv_kxk(*a, k=kk, stride=ss, pad=pp, act=o, **kw))
                plain_o = (qconv1x1_reference(*args, act=other, **kw) if name == "qconv1x1" else
                           qconv_kxk_reference(*args, k=k, stride=s, pad=pad, act=other, **kw))
                if not torch.equal(run_o(), plain_o):
                    raise AssertionError(f"{name} {k}x{k}/s{s} {cin}->{cout} @{h}x{w} {other}: "
                                         f"differs from the plain version")
                g_o = graph_ms(run_o)
            a_r = r["acts"][other]
            a_r["graph_ms"] += g_o
            a_r["weighted_graph_ms"] += per_forward[key] * g_o
            a_r["shapes"] += 1
            others.append(f"{other} bit-identical, device {g_o:.4f} ms")
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
        print(f"[kernels] {name} {at} {k}x{k}/s{s} {cin}->{cout} @{h}x{w} {act} -> {out} x{n_fwd} "
              f"a forward, tile {plan.bm}x{plan.bn} {'gather' if plan.gather else 'cp.async'}: "
              f"bit-identical; kernel device {gms:.4f} ms (graph replay), events {ms:.4f} ms, "
              f"plain {pms:.4f} ms; bound {bms:.4f} ms ({by}), {100 * bms / gms:.1f}% of bound, "
              f"{ops / gms / 1e9:.1f} TOP/s{'; ' if others else ''}{'; '.join(others)} | {card}",
              flush=True)
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
        r["at"] = f"{at}, sum over the {r['shapes']} distinct shapes of the int8 network"
        r["bound_by"] = "operations" if r.pop("ops_ms") > r.pop("bytes_ms") else "bytes"
        r["lost_per_forward_ms"] = r["weighted_graph_ms"] - r["weighted_bound_ms"]
        print(f"[times] {name} {at}, all {r['shapes']} shapes once: kernel device "
              f"{fmt_ms(r['device_ms'])} (graph replay {r['graph_ms']:.4f} ms, events "
              f"{r['ms']:.4f} ms), plain {r['plain_ms']:.4f} ms (device "
              f"{fmt_ms(r['plain_device_ms'])}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
              f"library {fmt_ms(r['library_ms'])} | {card}", flush=True)
        print(f"[times] {name} {at}, a forward ({r['launches_per_forward']} launches over "
              f"{r['shapes']} shapes): kernel device {fmt_ms(r['weighted_device_ms'])} (graph "
              f"replay {r['weighted_graph_ms']:.4f} ms), bound {r['weighted_bound_ms']:.4f} ms, "
              f"lost {r['lost_per_forward_ms']:.4f} ms | {card}", flush=True)
        for other, a_r in r["acts"].items():
            print(f"[times] {name} {at} with {other} at the same shapes: bit-identical at "
                  f"{a_r['shapes']} shapes; once each {a_r['graph_ms']:.4f} ms, a forward "
                  f"{a_r['weighted_graph_ms']:.4f} ms (graph replay) | {card}", flush=True)
    return res


def phase_int8_slice(qmodel, requests, device, card: str, label: str = "int8",
                     size=(640, 640), size_divisible: int = 32) -> dict:
    """The int8 model through ``YOLOv5.__call__`` in both dtypes and configs
    at ``size``, one request (the second) on each other route, then the
    card against the CPU run of the port on one 480x640 frame letterboxed
    to 640 (the CPU runs the plain versions in float64)."""
    import copy

    import torch

    from yolort_tpu_torch import YOLOv5
    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    models = {dt: YOLOv5(model=qmodel, device=device, dtype=dt, size=size,
                         size_divisible=size_divisible) for dt in (torch.float32, torch.bfloat16)}
    reset_launch_counts()
    outs = {}
    for dt, m in models.items():
        for name, cfg in (("eval", EVAL), ("serving", SERVING)):
            qmodel.score_thresh, qmodel.pre_nms_topk = cfg["score_thresh"], cfg["pre_nms_topk"]
            outs[(dt, name)] = [m(req) for req in requests]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    print(f"[{label}] int8 path launches: {launches}", flush=True)
    on_path = ROUTE_KERNELS[DEFAULT_ROUTE] + ("qconv1x1", "qconv_kxk")
    for kname, n in launches.items():
        if kname in on_path and n <= 0:
            raise AssertionError(f"{label}: kernel {kname} was not launched on the int8 path")
        if kname not in on_path and n:
            raise AssertionError(f"{label}: kernel {kname} launched on the int8 path, which does "
                                 f"not run it")
    for (dt, name), res in outs.items():
        counts = check_served(res, f"{label} {dt} {name}")
        print(f"[{label}] {str(dt):>14} {name:>7}: detections/img {counts}", flush=True)

    # one request, serving config, on each other route: its kernels launch
    # on the int8 head outputs and it serves the default route's detections
    qmodel.score_thresh, qmodel.pre_nms_topk = SERVING["score_thresh"], SERVING["pre_nms_topk"]
    for route in ROUTES[1:]:
        qmodel.row_gather = route
        reset_launch_counts()
        for dt, m in models.items():
            for d, d0 in zip(m(requests[1]), outs[(dt, "serving")][1]):
                if not all(np.array_equal(d[key], d0[key]) for key in ("boxes", "scores", "labels")):
                    raise AssertionError(f"{label} {route} {dt} serving: detections differ from "
                                         f"the default route's")
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in KERNELS}
        want = ROUTE_KERNELS[route] + ("qconv1x1", "qconv_kxk")
        for kname, n in counts.items():
            if (kname in want) != (n > 0):
                raise AssertionError(f"{label} route {route}: kernel {kname} launched {n} times")
        shape = (len(requests[1]), *requests[1][0].shape[:2])
        print(f"[{label}] route {route}, serving, {shape} in both dtypes: launches {counts}; "
              f"detections equal to the default route's", flush=True)
    qmodel.row_gather = DEFAULT_ROUTE

    # the card's int8 network against the CPU run of the port (plain
    # versions) on one 480x640 frame, same float32 canvas
    canvas = pair_canvas(size_divisible)
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
    print(f"[{label}] card vs CPU, 1x480x640 float32 on a {tuple(canvas.shape[1:3])} canvas: PAN int8 "
          f"features differing (count, of, max levels) "
          f"{flips}; head logits max abs diff {head_err:.3e} (max |logit| {head_max:.3f})", flush=True)
    # bound: the int8 activations identical but where the card's and the
    # CPU's sigmoid differ by an ulp at a rounding boundary (a one-level
    # flip; int8_witness holds each conv to that), and the flips' spread
    # downstream small on these weights, and logits within 1e-3 of the
    # largest logit
    for n, total, mx in flips:
        if n > 1e-3 * total or mx > 2:
            raise AssertionError(f"{label} card vs CPU: {n}/{total} feature values differ, up to "
                                 f"{mx} levels")
    if head_err > 1e-3 * head_max:
        raise AssertionError(f"{label} card vs CPU: head logits differ by {head_err} (max |logit| "
                             f"{head_max})")
    int8_witness(qmodel, canvas.to(device), label)

    unpaired = 0
    for dt in (torch.float32, torch.bfloat16):
        with torch.inference_mode():
            heads = qmodel.head_outputs(canvas.to(device, dt))
        for name, cfg in (("eval", EVAL), ("serving", SERVING)):
            qmodel.score_thresh, qmodel.pre_nms_topk = cfg["score_thresh"], cfg["pre_nms_topk"]
            with torch.inference_mode():
                det_gpu = qmodel.postprocess(heads)
                det_cpu = qmodel.postprocess([h.cpu() for h in heads])
            un = pair_detections(det_gpu, det_cpu, f"{label} {dt} {name}")
            unpaired += un
            print(f"[{label}] card vs CPU postprocess, int8 {dt} {name} "
                  f"{tuple(canvas.shape[1:3])}: counts equal, {un} unpaired", flush=True)
    return dict(launches=launches, models=models, unpaired=unpaired)


def pair_canvas(size_divisible: int):
    """The float32 canvas on which the card's int8 network is held against
    the CPU's: one 480x640 frame letterboxed to 640, on the CPU."""
    import torch

    from yolort_tpu_torch.models.transform import letterbox_batch, make_plan

    raw = torch.from_numpy(np.stack(frames(13, 1, 480, 640)))
    plan = make_plan([(480, 640)], 640, 640, size_divisible)[0]
    return letterbox_batch(raw.float() / 255.0, plan)


def int8_calls(model, x) -> list:
    """(name, module, input, output) of every quantized conv and residual
    add of ``model.head_outputs(x)``, in the order they finish."""
    import torch

    from yolort_tpu_torch.ops.blocks import Bottleneck, Conv, Conv2dOnly

    calls, hooks = [], []
    for name, mod in model.named_modules():
        if (isinstance(mod, (Conv, Conv2dOnly)) and mod.quantized) or (
                isinstance(mod, Bottleneck) and mod.add):
            hooks.append(mod.register_forward_hook(
                lambda m, i, o, name=name: calls.append((name, m, i[0], o))))
    try:
        with torch.inference_mode():
            model.head_outputs(x)
    finally:
        for h in hooks:
            h.remove()
    return calls


def _values(t):
    """The int8 values of a QTensor, or a float tensor as float64, on the CPU."""
    return t.q.cpu().int() if hasattr(t, "q") else t.cpu().double()


def _to_cpu(t):
    from yolort_tpu_torch.ops.blocks import QTensor

    return QTensor(t.q.cpu(), t.s, t.dtype) if isinstance(t, QTensor) else t.cpu()


def exact_epilogue(mod, xq, scale, bias, inv):
    """A quantized conv's output in float64 from its exact s32
    accumulator, before any rounding: ``y * inv`` (int8 out) or ``y``."""
    import torch
    import torch.nn.functional as F

    k, cout, cin = mod.k, mod.wq.shape[0], xq.shape[1] // mod.g
    w = mod.wq[:, : k * k * cin].reshape(cout, k, k, cin).permute(0, 3, 1, 2).double()
    y = F.conv2d(xq.double(), w, None, mod.s, mod.pad, 1, mod.g)
    y = y * scale.double().view(1, -1, 1, 1) + bias.double().view(1, -1, 1, 1)
    act = getattr(mod, "act", "none")
    if act == "silu":
        y = y * torch.sigmoid(y)
    elif act == "hardswish":
        y = y * torch.clamp(y + 3.0, 0.0, 6.0) / 6.0
    elif act == "leaky_relu":
        y = torch.where(y >= 0, y, 0.1 * y)
    elif act == "relu":
        y = y.clamp_min(0.0)
    return y if inv is None else y * inv


def plain_qconv(mod, xq, scale, bias, **kw):
    """The plain version of the qconv kernel that quantized conv ``mod``
    launches (``qconv_kernel.qconv``'s dispatch)."""
    from yolort_tpu_torch.ops.cuda import (
        qconv1x1_reference, qconv_grouped_reference, qconv_kxk_reference,
    )

    if mod.g > 1:
        return qconv_grouped_reference(xq, mod.wq, scale, bias, k=mod.k, stride=mod.s,
                                       pad=mod.pad, groups=mod.g, **kw)
    if kernel_of(mod, xq.shape[1]) == "qconv1x1":
        return qconv1x1_reference(xq, mod.wq, scale, bias, **kw)
    return qconv_kxk_reference(xq, mod.wq, scale, bias, k=mod.k, stride=mod.s, pad=mod.pad, **kw)


def kernel_of(mod, cin: int) -> str:
    """The qconv kernel that quantized conv ``mod`` launches on an input of
    ``cin`` channels."""
    if mod.g > 1:
        return "qconv_grouped"
    return "qconv1x1" if mod.k == 1 and mod.s == 1 and mod.pad == 0 and cin % 4 == 0 else "qconv_kxk"


def int8_witness(qmodel, canvas, label: str, max_ulps: int = 8) -> dict:
    """Where the card's int8 network and the CPU run of the port part, conv
    by conv, on one float32 canvas.

    Chained: the card and the CPU each feed their own values forward; the
    first quantized conv or residual add whose output differs is printed
    with the count at every later one.  Teacher-forced: every quantized
    conv of the CPU copy and the plain version on the card are given the
    card's own input to that conv, and held against the card's output and
    the exact value (``exact_epilogue``).  Fails unless, at every conv,
    the kernel equals its plain version on the card bit for bit and every
    value where the card and the CPU part is one int8 level apart with an
    exact value within ``max_ulps`` float32 ulps of a rounding boundary
    (head convs, float out: within ``max_ulps`` ulps of each other); and
    unless every residual add of the card's inputs gives the card's sum
    on the CPU."""
    import copy

    import torch

    from yolort_tpu_torch.ops.blocks import Bottleneck, _qadd, inv_scale

    cpu_model = copy.deepcopy(qmodel).cpu()
    cpu_mods = dict(cpu_model.named_modules())
    card = int8_calls(qmodel, canvas)
    cpu = int8_calls(cpu_model, canvas.cpu())
    if [c[0] for c in card] != [c[0] for c in cpu]:
        raise AssertionError(f"{label} witness: the card and the CPU ran different modules")

    chained, first = [], None
    for (name, _, _, yg), (_, _, _, yc) in zip(card, cpu):
        d = (_values(yg) - _values(yc)).abs()
        n = int((d > 0).sum())
        chained.append((name, n, d.numel(), float(d.max())))
        if n and first is None:
            first = name
    forced = []
    prev = {}
    with torch.inference_mode():
        for name, mod, xg, yg in card:
            if isinstance(mod, Bottleneck):
                # the add of the card's input and its cv2 output, on the CPU
                y = _qadd(_to_cpu(xg), _to_cpu(prev[name + ".cv2"]), cpu_mods[name].as_)
                n = int((_values(y) != _values(yg)).sum())
                if n:
                    raise AssertionError(f"{label} witness: residual add {name} differs from the "
                                         f"card's on its inputs at {n} values")
                continue
            prev[name] = yg
            xq, scale, bias, os, ft = mod.qconv_operands(xg)
            inv = None if os is None else inv_scale(os)
            kw = dict(act=getattr(mod, "act", "none"), inv_out_scale=inv, out_dtype=ft)
            plain = plain_qconv(mod, xq, scale, bias, **kw)
            card_v = _values(yg)
            n_plain = int((card_v != _values(plain)).sum())
            if n_plain:
                raise AssertionError(f"{label} witness: {name}: the kernel differs from its plain "
                                     f"version on the card at {n_plain} values")
            cpu_v = _values(cpu_mods[name](_to_cpu(xg)))
            exact = exact_epilogue(mod, xq, scale, bias, inv).cpu()
            part = card_v != cpu_v
            n = int(part.sum())
            if os is None:
                # float out: the distance of card and CPU in float32 ulps
                a, b = card_v.float(), cpu_v.float()
                ulp = (torch.nextafter(a.abs(), torch.tensor(float("inf"))) - a.abs()).double()
                far = float(((a.double() - b.double()).abs() / ulp).max())
                forced.append((name, n, card_v.numel(), far, None, None))
                if far > max_ulps:
                    raise AssertionError(f"{label} witness: {name} card and CPU logits {far} "
                                         f"ulps apart")
                continue
            rounded = exact.round().clamp(-127, 127)
            n_card = int((card_v.double() != rounded).sum())
            n_cpu = int((cpu_v.double() != rounded).sum())
            far = 0.0
            if n:
                t = exact[part]
                levels = int((card_v - cpu_v).abs().max())
                ulp = (torch.nextafter(t.float().abs(), torch.tensor(float("inf")))
                       - t.float().abs()).double()
                far = float(((t - (t.floor() + 0.5)).abs() / ulp).max())
                if levels > 1 or far > max_ulps:
                    raise AssertionError(f"{label} witness: {name}: card and CPU differ at {n} "
                                         f"values, up to {levels} levels, exact values up to "
                                         f"{far:.1f} ulps from a rounding boundary")
            forced.append((name, n, card_v.numel(), far, n_card, n_cpu))
    print(f"[{label}] witness, teacher-forced, {len(forced)} quantized convs: (conv, card != CPU, "
          f"of, the largest distance of those from a rounding boundary in f32 ulps (float out: "
          f"card - CPU in ulps), card != exact, CPU != exact): "
          f"{[f for f in forced if f[1] or f[4] or f[5]]}; every other conv equal on all three; "
          f"in all, of {sum(f[2] for f in forced)} values, card != CPU {sum(f[1] for f in forced)}, "
          f"card != exact {sum(f[4] or 0 for f in forced)}, CPU != exact "
          f"{sum(f[5] or 0 for f in forced)}", flush=True)
    print(f"[{label}] witness, chained: first output to differ {first}; (module, differing, of, "
          f"max |diff|) from there: {chained[[c[0] for c in chained].index(first):] if first else []}",
          flush=True)
    zero = [name for name, _, _, y in card if hasattr(y, "q") and not bool(y.q.any())]
    print(f"[{label}] int8 outputs all 0 on the card: {zero}", flush=True)
    return dict(forced=forced, chained=chained, first=first, zero=zero)


def flip_spread(qmodel, canvas, target: str) -> list:
    """(module, differing, of, max |diff|) of every quantized conv and
    residual add from ``target`` on: the card's int8 network with one value
    of ``target``'s int8 output moved by one level (the middle of the first
    image), against the same network unchanged, on the same canvas."""
    from yolort_tpu_torch.ops.blocks import QTensor

    def hook(mod, inputs, out):
        q = out.q.clone()
        _, c, h, w = q.shape
        v = int(q[0, c // 2, h // 2, w // 2])
        q[0, c // 2, h // 2, w // 2] = v + 1 if v < 127 else v - 1
        return QTensor(q, out.s, out.dtype)

    base = int8_calls(qmodel, canvas)
    handle = dict(qmodel.named_modules())[target].register_forward_hook(hook)
    try:
        moved = int8_calls(qmodel, canvas)
    finally:
        handle.remove()
    names = [c[0] for c in base]
    out = []
    for (name, _, _, a), (_, _, _, b) in zip(base[names.index(target):], moved[names.index(target):]):
        d = (_values(a) - _values(b)).abs()
        out.append((name, int((d > 0).sum()), d.numel(), float(d.max())))
    return out


def phase_p6_int8_seeded(device, requests) -> dict:
    """yolov5s6 @1280 in int8 on its seeded random weights, built as phase
    5 builds yolov5s, held against the CPU conv by conv (``int8_witness``)
    on phase 5's 480x640 frame; then the spread of one flip of one level
    at the first conv where the card and the CPU part, on the card alone
    (``flip_spread``), beside the chained count at each PAN output.  This
    network's activations shrink by some 10^9 through its depth, and its
    up walk's int8 outputs are all 0 where a concat's unified scale is far
    above them: its int8 card-vs-CPU comparison is made here, where each
    conv's rule holds on any weights, and served and paired end to end on
    the fabricated checkpoint's weights (phase 6)."""
    import torch

    import yolort_tpu_torch

    fmodel = yolort_tpu_torch.yolov5s6(device=device, dtype=torch.float32, seed=0, size=P6_SIZE)
    qmodel = build_int8(fmodel, device, requests, frames(22, 8, 1280, 1280), "p6 int8 seeded")
    canvas = pair_canvas(64).to(device)
    wit = int8_witness(qmodel, canvas, "p6 int8 seeded")
    outs = [c[0] for c in wit["chained"] if c[0].endswith(".cv3") and c[0].startswith("pan.layer.")]
    chained = {c[0]: c[1:] for c in wit["chained"]}
    print(f"[p6 int8 seeded] PAN outputs (differing, of, max levels), card vs CPU chained: "
          f"{[(o, chained[o]) for o in outs]}", flush=True)
    for name, n, *_ in wit["forced"]:
        if n:
            spread = {c[0]: c[1:] for c in flip_spread(qmodel, canvas, name)}
            print(f"[p6 int8 seeded] one flip at {name} (where the card and the CPU part {n} "
                  f"times), on the card alone: {[(o, spread.get(o)) for o in outs]}", flush=True)
    mods = dict(qmodel.named_modules())
    scales = {name: f"{mods[name].os:.3e}" for i in range(1, 2 * len(outs) - 1, 2)
              for name in (f"pan.layer.{i}", f"pan.layer.{i + 1}.cv1")}
    print(f"[p6 int8 seeded] output scales of the up walk's downsamples (unified with their "
          f"concat group) and of the convs that read them: {scales}", flush=True)
    return wit


def oracle_hwa(oracle, canvas, outs, no: int):
    """The fixture oracle's decoded predictions of a float32 NHWC canvas on
    the CPU, reordered per level from its (anchor, h, w) order to the
    port's (h, w, anchor)."""
    import torch

    with torch.inference_mode():
        ref = oracle(canvas.permute(0, 3, 1, 2).contiguous()).numpy()
    parts, off = [], 0
    for o in outs:
        h, w = o.shape[1:3]
        parts.append(ref[:, off:off + 3 * h * w].reshape(-1, 3, h, w, no)
                     .transpose(0, 2, 3, 1, 4).reshape(ref.shape[0], -1, no))
        off += 3 * h * w
    return np.concatenate(parts, axis=1)


# (label, make_checkpoint keywords, load_from_yolov5 keywords, decode
# tolerance (rtol, atol) of the JAX test of the family)
CHECKPOINTS = (
    ("s6 r6.0", dict(dm=0.33, wm=0.5, p6=True), dict(size=P6_SIZE, size_divisible=64),
     (2e-3, 3e-2)),
    ("n r3.1", dict(version="r3.1"), dict(version="r3.1"), (2e-3, 3e-2)),
    ("n r4.0", dict(version="r4.0"), dict(version="r4.0"), (2e-3, 3e-2)),
    ("n tan", dict(version="tan"), dict(version="r4.0", use_tan=True), (2e-3, 3e-2)),
)


def torch_fixture():
    """tests/torch_fixture.py, loaded by path: an installed package named
    'tests' would shadow the checkout's test directory."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "torch_fixture", Path(__file__).resolve().parent / "tests" / "torch_fixture.py")
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    return fixture


def fabricate(tmp: str, label: str, make_kw=None):
    """(path, torch oracle) of the CHECKPOINTS entry ``label`` (or of
    ``make_kw``, the make_checkpoint keywords), written into ``tmp`` by
    tests/torch_fixture.make_checkpoint (80 classes, seed 0)."""
    if make_kw is None:
        make_kw = next(mk for lab, mk, _, _ in CHECKPOINTS if lab == label)
    path = f"{tmp}/{label.replace(' ', '_')}.pt"
    return path, torch_fixture().make_checkpoint(path, nc=80, seed=0, **make_kw)


def phase_checkpoints(tmp: str, made: dict, device, card: str) -> dict:
    """Ultralytics-layout checkpoints fabricated by
    tests/torch_fixture.make_checkpoint into ``tmp``, or taken from
    ``made`` ({label: (path, oracle)}) (80 classes, fp16, random
    BatchNorm statistics): yolov5s6 at full width @1280, and nano r3.1,
    r4.0 and TAN @640, each loaded by ``YOLOv5.load_from_yolov5`` on the
    card in both dtypes and on the CPU.  Each serves frames on the card
    through the default route (its kernels must launch, and no other);
    on one frame its card decode agrees with the fixture's torch oracle
    within the JAX test's tolerance, its card head outputs with the CPU's
    within 1e-3 of the largest logit, and the card's postprocess of its
    head outputs (on a 1/64 grid, see below) pairs with the CPU's in both
    dtypes.  The card's postprocess is paired with the CPU's on
    real-valued logits in phases 4 and 6 (seeded weights), not here."""
    import torch

    from yolort_tpu_torch import YOLOv5
    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    requests = {"s6 r6.0": [frames(17, 2, 720, 1280), frames(18, 1, 1280, 1280)]}
    unpaired, launches = 0, {}
    for label, _, load_kw, (rtol, atol) in CHECKPOINTS:
        t0 = time.perf_counter()
        path, oracle = made[label] if label in made else fabricate(tmp, label)
        models = {dt: YOLOv5.load_from_yolov5(path, device=device, dtype=dt, **load_kw)
                  for dt in (torch.float32, torch.bfloat16)}
        cpu = YOLOv5.load_from_yolov5(path, device="cpu", **load_kw)
        reqs = requests.get(label, [frames(19, 2, 480, 640)])
        reset_launch_counts()
        for dt, m in models.items():
            counts = [check_served([m(req)], f"checkpoint {label} {dt}") for req in reqs]
            print(f"[checkpoint] {label} {dt} served: detections/img {counts}", flush=True)
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in KERNELS}
        for kname, n in counts.items():
            if (kname in ROUTE_KERNELS[DEFAULT_ROUTE]) != (n > 0):
                raise AssertionError(f"checkpoint {label}: kernel {kname} launched {n} times")
        for kname, n in counts.items():
            launches[kname] = launches.get(kname, 0) + n

        raw = torch.from_numpy(np.stack(reqs[0][:1]))
        canvas = cpu.canvas(raw)[0]
        with torch.inference_mode():
            outs = models[torch.float32].model.head_outputs(canvas.to(device))
            dec = models[torch.float32].model.decode(canvas.to(device)).cpu().numpy()
            outs_cpu = cpu.model.head_outputs(canvas)
        ref = oracle_hwa(oracle, canvas, outs_cpu, 85)
        print(f"[checkpoint] {label}: PAN outputs' max |value| by level "
              f"{pan_absmax(models[torch.float32], reqs[0][:1])}; near-ties among the 4096 best "
              f"pair scores {100 * near_tie_share(outs):.1f}% of the gaps", flush=True)
        dec_err = np.abs(dec - ref).max()
        bad = ~np.isclose(dec, ref, rtol=rtol, atol=atol)
        bad[..., 4:] |= np.abs(dec[..., 4:] - ref[..., 4:]) > 2e-3
        if bad.any():
            raise AssertionError(f"checkpoint {label}: card decode differs from the torch "
                                 f"oracle at {int(bad.sum())} values (max abs {dec_err})")
        head_err = max((g.cpu() - c).abs().max().item() for g, c in zip(outs, outs_cpu))
        head_max = max(c.abs().max().item() for c in outs_cpu)
        if head_err > 1e-3 * head_max:
            raise AssertionError(f"checkpoint {label}: card head outputs differ from the CPU's "
                                 f"by {head_err} (max |logit| {head_max})")
        print(f"[checkpoint] {label} {tuple(canvas.shape[1:3])}: card decode vs torch oracle "
              f"max abs {dec_err:.3e} (rtol {rtol}, atol {atol}); card vs CPU head outputs "
              f"max abs {head_err:.3e} of max |logit| {head_max:.3f}", flush=True)
        for dt, m in models.items():
            with torch.inference_mode():
                # the head outputs on a 1/64 grid, the same on both sides: a
                # fabricated network scores every pair within 0.002 of the
                # others (98% of the gaps between its top 4096 scores are
                # under 4 ulps), where the card's and the CPU's sigmoids,
                # which differ by an ulp, reorder them; on the grid two
                # scores are equal or far more than an ulp apart
                heads = [(torch.round(h * 64) / 64).contiguous()
                         for h in m.model.head_outputs(canvas.to(device, dt))]
                det_gpu = m.model.postprocess(heads)
                det_cpu = m.model.postprocess([h.cpu() for h in heads])
            un = pair_detections(det_gpu, det_cpu, f"checkpoint {label} {dt}")
            unpaired += un
            print(f"[checkpoint] {label} {dt} card vs CPU postprocess: counts equal, "
                  f"{un} unpaired; {time.perf_counter() - t0:.1f} s", flush=True)
        del models, cpu
    return dict(launches=launches, unpaired=unpaired)


# --------------------------------------------------------------------------
# the serving surface beside the cell path: r3.1 int8, classes_per_anchor,
# decoded predictions, fixed_shape canvases
# --------------------------------------------------------------------------

R31 = dict(dm=0.33, wm=0.5, version="r3.1")  # yolov5s r3.1 at full width
CPA = 4  # classes_per_anchor of the flatten-path phase
# the kernels of the flatten and decoded paths on each route, a batch: both
# selections run select_topk_threshold, so bisect_count and the route's
# fetch kernel twice (stage 1, stage 2), then nms_mask
FLATTEN_KERNELS = {
    route: {"bisect_count": 2, "nms_mask": 1, fetch: 2}
    for route, fetch in zip(ROUTES, ("row_fetch", "lookup_fetch", "select_extract"))
}
FIXED_SHAPE = (640, 640)


def phase_r31_int8(device, requests, card: str):
    """yolov5s r3.1 (Hardswish, Focus, BottleneckCSP, SPP) at full width
    @640 in int8, on the weights of a fabricated r3.1 checkpoint (seeded
    weights' activations vanish with depth): built by the bench recipe, the
    qconv kernels at every conv shape at batch 8 with its Hardswish
    epilogue, and with LeakyReLU (which no network reaches) and SiLU at
    the same shapes, bit-identical to the plain versions; then phase 5's
    serving, routes and card-vs-CPU checks (``phase_int8_slice``).
    Returns (the qconv results, the serving phase's launches)."""
    from yolort_tpu_torch import YOLOv5
    from yolort_tpu_torch.ops.blocks import Conv

    with tempfile.TemporaryDirectory() as tmp:
        path, _ = fabricate(tmp, "s r3.1", R31)
        fmodel = YOLOv5.load_from_yolov5(path, version="r3.1", device=device)
    acts = {mod.act for mod in fmodel.model.modules() if isinstance(mod, Conv)}
    if acts != {"hardswish"}:
        raise AssertionError(f"r3.1: conv activations {acts}, want hardswish only")
    batch = frames(23, 8, 640, 640)
    qmodel = build_int8(fmodel, device, requests, batch, "r3.1 int8")
    res = phase_qconv_kernels(qmodel, fmodel, batch, B, device, card,
                              other_acts=("leaky_relu", "silu"))
    q = phase_int8_slice(qmodel, requests, device, card, "r3.1 int8")
    del q["models"], qmodel, fmodel
    return res, q["launches"]


def run_path(path: str, m, req, route: str, cfg: dict) -> list:
    """One request of ``YOLOv5`` ``m`` through a postprocess path, as
    per-image detection dicts: 'cpa' is ``__call__`` with
    ``classes_per_anchor`` set (the flatten path), 'decoded' is
    ``batched_postprocess`` of ``YOLO.decode`` of the request's canvas,
    scaled back to the frame."""
    import torch

    from yolort_tpu_torch.models.transform import scale_coords_back
    from yolort_tpu_torch.ops.nms import batched_postprocess

    yolo = m.model
    yolo.row_gather = route
    yolo.score_thresh, yolo.pre_nms_topk = cfg["score_thresh"], cfg["pre_nms_topk"]
    if path == "cpa":
        yolo.classes_per_anchor = CPA
        try:
            return m(req)
        finally:
            yolo.classes_per_anchor = None
    x = torch.from_numpy(np.stack(req)).to(m.device)
    with torch.inference_mode():
        canvas, plan = m.canvas(x)
        det = batched_postprocess(yolo.decode(canvas), num_classes=yolo.num_classes,
                                  score_thresh=yolo.score_thresh, nms_thresh=yolo.nms_thresh,
                                  detections_per_img=yolo.detections_per_img,
                                  pre_nms_topk=yolo.pre_nms_topk, row_gather=route)
        orig = torch.tensor(x.shape[1:3], dtype=torch.float32, device=x.device)
        det = det._replace(boxes=scale_coords_back(det.boxes, plan.canvas_hw, orig))
    out = []
    for i in range(x.shape[0]):
        n = int(det.num[i])
        out.append({"boxes": det.boxes[i, :n].float().cpu().numpy(),
                    "scores": det.scores[i, :n].float().cpu().numpy(),
                    "labels": det.labels[i, :n].cpu().numpy().astype(np.int64)})
    return out


def postprocess_path(path: str, yolo, inp, route: str):
    """The path's Detections, in canvas coordinates, of ``inp``: head
    outputs ('cpa') or decoded predictions ('decoded'), on their device."""
    from yolort_tpu_torch.ops.nms import batched_postprocess

    yolo.row_gather = route
    if path == "cpa":
        yolo.classes_per_anchor = CPA
        try:
            return yolo.postprocess(inp)
        finally:
            yolo.classes_per_anchor = None
    return batched_postprocess(inp, num_classes=yolo.num_classes,
                               score_thresh=yolo.score_thresh, nms_thresh=yolo.nms_thresh,
                               detections_per_img=yolo.detections_per_img,
                               pre_nms_topk=yolo.pre_nms_topk, row_gather=route)


def phase_flatten_paths(models, requests, card: str) -> dict:
    """The flatten path (``classes_per_anchor`` = CPA, through
    ``YOLOv5.__call__``) and the decoded path (``batched_postprocess`` of
    ``YOLO.decode``) on the float yolov5s slice's models and requests, in
    both dtypes and configs, once per route, each route's counts set to 0
    just before and read just after: exactly FLATTEN_KERNELS a batch (no
    stage-1 kernel, no other); every image with detections; each route's
    detections equal to the default route's; then, on the 4x480x640
    request, the card's postprocess of the card's head outputs (decoded
    predictions) paired with the CPU's on every route, and each path's
    postprocess time per route (CUDA events, device)."""
    import torch

    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    runs = [(dt, name, cfg) for dt in models for name, cfg in (("eval", EVAL), ("serving", SERVING))]
    batches = len(runs) * len(requests)
    out = {}
    for path in ("cpa", "decoded"):
        launches, served = {}, {}
        for route in ROUTES:
            reset_launch_counts()
            for dt, name, cfg in runs:
                served[(route, dt, name)] = [run_path(path, models[dt], req, route, cfg)
                                             for req in requests]
            torch.cuda.synchronize()
            counts = {fn.__name__: fn.launches for fn in KERNELS}
            want = {k: FLATTEN_KERNELS[route].get(k, 0) * batches for k in counts}
            print(f"[{path}] route {route}: launches over {batches} batches {counts}", flush=True)
            if counts != want:
                raise AssertionError(f"{path} route {route}: launches {counts}, want {want}")
            launches[route] = counts
        for (route, dt, name), res in served.items():
            counts = check_served(res, f"{path} {route} {dt} {name}")
            if route == DEFAULT_ROUTE:
                print(f"[{path}] {str(dt):>14} {name:>7}: detections/img {counts}", flush=True)
                continue
            for req, req0 in zip(res, served[(DEFAULT_ROUTE, dt, name)]):
                for d, d0 in zip(req, req0):
                    if not all(np.array_equal(d[k], d0[k]) for k in ("boxes", "scores", "labels")):
                        raise AssertionError(f"{path} {route} {dt} {name}: detections differ "
                                             f"from the default route's")
        print(f"[{path}] every route served the default route's detections exactly", flush=True)

        unpaired, times = 0, {}
        for dt, m in models.items():
            yolo = m.model
            x = torch.from_numpy(np.stack(requests[1])).to(m.device)
            with torch.inference_mode():
                canvas = m.canvas(x)[0]
                inp = yolo.head_outputs(canvas) if path == "cpa" else yolo.decode(canvas)
            inp_cpu = [h.cpu() for h in inp] if path == "cpa" else inp.cpu()
            for name, cfg in (("eval", EVAL), ("serving", SERVING)):
                yolo.score_thresh, yolo.pre_nms_topk = cfg["score_thresh"], cfg["pre_nms_topk"]
                line = []
                for route in ROUTES:
                    with torch.inference_mode():
                        det = postprocess_path(path, yolo, inp, route)
                        det_cpu = postprocess_path(path, yolo, inp_cpu, route)
                        ev = median_ms(lambda: postprocess_path(path, yolo, inp, route), 5, 3)
                        dev = device_profile(lambda: postprocess_path(path, yolo, inp, route),
                                             iters=3)[0]
                    unpaired += pair_detections(det, det_cpu, f"{path} {route} {dt} {name}")
                    times[(str(dt), name, route)] = (ev, dev)
                    line.append(f"{route} {ev:.3f} ms (device {fmt_ms(dev)})")
                print(f"[{path}] card vs CPU, 4x480x640 {dt} {name}: counts equal on every route; "
                      f"postprocess by route {'; '.join(line)} | {card}", flush=True)
            yolo.row_gather = DEFAULT_ROUTE
        print(f"[{path}] unpaired card vs CPU over every route, dtype and config: {unpaired}",
              flush=True)
        totals = {k: sum(launches[r][k] for r in ROUTES) for k in launches[DEFAULT_ROUTE]}
        out[path] = dict(launches=totals, unpaired=unpaired, times=times)
    return out


def as_detections(d: dict):
    """A per-image detection dict as a batch-1 Detections."""
    import torch

    from yolort_tpu_torch.ops.nms import Detections

    n = len(d["scores"])
    return Detections(torch.from_numpy(d["boxes"])[None], torch.from_numpy(d["scores"])[None],
                      torch.from_numpy(d["labels"])[None], torch.ones(1, n, dtype=torch.bool),
                      torch.tensor([n]))


def phase_fixed_shape(models, device, card: str, hub_name: str = "yolov5s") -> dict:
    """A mixed-size request (720x1280, 480x640, 1080x1920 frames) served as
    one batch on a FIXED_SHAPE canvas by the float yolov5s slice's models
    (``YOLOv5(fixed_shape=...)``), both dtypes and configs: exactly the
    default route's kernels, one batch a call; each canvas slice equal to
    its frame's own canvas bit for bit; the postprocess of the batch's
    head outputs equal, image by image, to each image's postprocess alone;
    each image's detections paired with those of the frame served alone;
    the card's postprocess paired with the CPU's, and the card's canvas
    beside the CPU's; then ``predict_rich`` and the hub file's factory
    ``hub_name`` (the models' own) on the card."""
    import copy
    from pathlib import Path

    import torch

    from yolort_tpu_torch import YOLOv5
    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    mixed = [frames(24, 1, 720, 1280)[0], frames(25, 1, 480, 640)[0], frames(26, 1, 1080, 1920)[0]]
    fixed = {dt: YOLOv5(model=m.model, device=device, dtype=dt, size=FIXED_SHAPE,
                        fixed_shape=FIXED_SHAPE) for dt, m in models.items()}
    reset_launch_counts()
    served = {}
    for dt, fm in fixed.items():
        for name, cfg in (("eval", EVAL), ("serving", SERVING)):
            fm.model.score_thresh, fm.model.pre_nms_topk = cfg["score_thresh"], cfg["pre_nms_topk"]
            served[(dt, name)] = fm(mixed)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    want = {k: DEFAULT_PER_BATCH.get(k, 0) * len(served) for k in launches}
    print(f"[fixed_shape] {len(served)} mixed-size batches of 3 on a {FIXED_SHAPE} canvas: "
          f"launches {launches}", flush=True)
    if launches != want:
        raise AssertionError(f"fixed_shape: launches {launches}, want {want}")

    unpaired = 0
    for (dt, name), res in served.items():
        fm = fixed[dt]
        yolo = fm.model
        cfg = EVAL if name == "eval" else SERVING
        yolo.score_thresh, yolo.pre_nms_topk = cfg["score_thresh"], cfg["pre_nms_topk"]
        counts = check_served([res], f"fixed_shape {dt} {name}")
        raws = [torch.from_numpy(im).to(device) for im in mixed]
        with torch.inference_mode():
            canvas = fm.canvas_mixed(raws)
            for i, r in enumerate(raws):
                if not torch.equal(canvas[i], fm.canvas(r[None])[0][0]):
                    raise AssertionError(f"fixed_shape {dt}: canvas slice {i} differs from its "
                                         f"frame's own canvas")
            heads = yolo.head_outputs(canvas)
            det = yolo.postprocess(heads)
            for i in range(len(raws)):
                one = yolo.postprocess([h[i:i + 1].contiguous() for h in heads])
                if not all(torch.equal(a[i:i + 1], b) for a, b in zip(det, one)):
                    raise AssertionError(f"fixed_shape {dt} {name}: image {i}'s postprocess in "
                                         f"the batch differs from its own")
            det_cpu = yolo.postprocess([h.cpu() for h in heads])
        un = pair_detections(det, det_cpu, f"fixed_shape card vs CPU {dt} {name}")
        alone_un = sum(pair_detections(as_detections(fm([im])[0]), as_detections(d),
                                       f"fixed_shape alone {dt} {name} {im.shape[:2]}")
                       for im, d in zip(mixed, res))
        unpaired += un + alone_un
        print(f"[fixed_shape] {str(dt):>14} {name:>7}: detections/img {counts}; canvas slices "
              f"equal to each frame's own canvas; batch postprocess equal to each image's own; "
              f"card vs CPU postprocess {un} unpaired; each image against its frame served "
              f"alone {alone_un} unpaired", flush=True)
    cpu = YOLOv5(model=copy.deepcopy(models[torch.float32].model).cpu(), device="cpu",
                 size=FIXED_SHAPE, fixed_shape=FIXED_SHAPE)
    with torch.inference_mode():
        c_gpu = fixed[torch.float32].canvas_mixed([torch.from_numpy(im).to(device) for im in mixed])
        c_cpu = cpu.canvas_mixed([torch.from_numpy(im) for im in mixed])
    canvas_err = (c_gpu.cpu() - c_cpu).abs().max().item()
    print(f"[fixed_shape] float32 canvas, card vs CPU: max abs diff {canvas_err:.3e}", flush=True)
    if canvas_err > 1e-6:
        raise AssertionError(f"fixed_shape: the card's canvas differs from the CPU's by {canvas_err}")

    fm = fixed[torch.float32]
    fm.model.score_thresh, fm.model.pre_nms_topk = SERVING["score_thresh"], SERVING["pre_nms_topk"]
    rich = fm.predict_rich(mixed)
    base = served[(torch.float32, "serving")]
    if [len(r) for r in rich.records()] != [len(d["boxes"]) for d in base]:
        raise AssertionError("fixed_shape: predict_rich's records differ from the served detections")
    hub = torch.hub.load(str(Path(__file__).resolve().parent / "yolort_tpu_torch"), hub_name,
                         source="local", device=device, size=FIXED_SHAPE, fixed_shape=FIXED_SHAPE,
                         seed=0)
    hub.model.load_state_dict(fm.model.state_dict())
    hub.model.score_thresh, hub.model.pre_nms_topk = SERVING["score_thresh"], SERVING["pre_nms_topk"]
    for d, d0 in zip(hub(mixed), base):
        if not all(np.array_equal(d[k], d0[k]) for k in ("boxes", "scores", "labels")):
            raise AssertionError("fixed_shape: the hub factory's model serves other detections")
    print(f"[fixed_shape] predict_rich on the card: records per image "
          f"{[len(r) for r in rich.records()]}, summary {len(rich.summary())} characters; the hub file's "
          f"{hub_name} (torch.hub.load, source='local', {hub.device}) served the same detections",
          flush=True)
    return dict(launches=launches, unpaired=unpaired)


def serving_times(models, card: str, label: str, batch) -> dict:
    """``label``'s serving of one uint8 ``batch`` on each route: images/s
    (host clock, median of 5), the device-busy time of one call and its
    share of the wall time (profiler), in both dtypes."""
    import torch

    n, (h, w) = len(batch), batch[0].shape[:2]
    out = {}
    for dt, m in models.items():
        m.model.score_thresh, m.model.pre_nms_topk = SERVING["score_thresh"], SERVING["pre_nms_topk"]
        for route in ROUTES:
            m.model.row_gather = route
            m(batch)
            ts = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m(batch)
                ts.append(time.perf_counter() - t0)
            sec = float(np.median(ts))
            busy = device_profile(lambda: m(batch), iters=3)[0]
            share = f"{100 * busy / (sec * 1e3):.1f}%" if busy else "not measured"
            out[(str(dt), route)] = dict(images_per_s=n / sec, batch_ms=sec * 1e3, device_busy_ms=busy)
            print(f"[times] {label} serving {dt} batch {n} @{h}x{w} uint8, route {route}: "
                  f"{n / sec:.1f} images/s ({sec * 1e3:.2f} ms/batch, host clock, median of 5); "
                  f"device busy {fmt_ms(busy)} ({share} of the wall) | {card}", flush=True)
        m.model.row_gather = DEFAULT_ROUTE
    return out


def phase_throughput(models, card: str, label: str) -> None:
    """Images/s at batch 32 in the serving config, then where a batch's
    time goes: network and postprocess by CUDA events, device busy time,
    the heaviest kernels and the hand-written kernels' share by
    torch.profiler."""
    import torch

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
        with torch.inference_mode():
            def net():
                return yolo.head_outputs(m.canvas(x)[0])

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


def phase_route_times(models, card: str, label: str = "yolov5s", batch=None) -> dict:
    """The postprocess's time per route on the head outputs of ``batch``
    (default 32 frames @640), both configs, both dtypes: CUDA events
    around back-to-back calls (host gaps included) and the profiler's
    device time."""
    import torch

    batch = frames(20, 32, 640, 640) if batch is None else batch
    out = {}
    for dt, m in models.items():
        yolo = m.model
        x = torch.from_numpy(np.stack(batch)).to(m.device)
        with torch.inference_mode():
            heads = yolo.head_outputs(m.canvas(x)[0])
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
                print(f"[times] {label} postprocess {dt} {name} batch {len(batch)} "
                      f"@{batch[0].shape[0]}x{batch[0].shape[1]} by route: {'; '.join(line)} "
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



# --------------------------------------------------------------------------
# phase 10: the rest of the model zoo
# --------------------------------------------------------------------------
LITE_640 = ((80, 80), (40, 40), (20, 20), (10, 10))  # yolo_lite head levels @640
# the stage-1 tables (rows of 128 anchors) of the zoo's paths @640:
# yolo_lite's cell path (25,500 anchors), the Ensemble of yolov5s and
# yolov5m (50,400) and TTA of yolov5s (55,755)
ZOO_TABLES = (200, 394, 436)


def phase_zoo_kernels(device, card: str) -> dict:
    """``check_stage1_kernels`` at the zoo's shapes: yolo_lite's four head
    levels @640 and the three stage-1 tables of ZOO_TABLES."""
    cells, tables, err = check_stage1_kernels(device, card, "zoo", (LITE_640,), ZOO_TABLES)
    return {"fused_cells_stage1": dict(zoo=cells, zoo_max_abs_err=err["fused_cells_stage1"]),
            "bisect_count": dict(zoo_stage1=tables, zoo_max_abs_err=err["bisect_count"])}


def lite_v5(*, device, dtype, seed):
    """yolo_lite, 80 classes, seeded, served with stride-64 rounding."""
    from yolort_tpu_torch import YOLOv5, yolov5_mobilenet_v3_small_fpn

    return YOLOv5("yolov5_mobilenet_v3_small_fpn", dtype=dtype, size_divisible=64,
                  model=yolov5_mobilenet_v3_small_fpn(device=device, dtype=dtype, seed=seed))


def yaml_v5(*, device, dtype, seed):
    """yolov5s assembled from its yaml config, seeded."""
    from yolort_tpu_torch import YOLOv5
    from yolort_tpu_torch.models.yaml_model import YAMLDetectionModel, build_yaml_config

    return YOLOv5("yaml yolov5s", dtype=dtype,
                  model=YAMLDetectionModel(build_yaml_config("s"), device=device, dtype=dtype,
                                           seed=seed))


def phase_zoo_served(device, requests, card: str) -> dict:
    """(a) yolo_lite and (b) yolov5s from its yaml config at full width, as
    phase 4 serves yolov5s: seeded weights, head biases shifted to phase
    4's candidate load, the three requests in both dtypes and configs on
    every route (every route's detections equal to the default's, the
    default route exactly DEFAULT_PER_BATCH a batch); the card paired
    with the CPU on the 4x480x640 request (yolo_lite's head outputs on a
    1/64 grid: its seeded network's best pair scores lie ulps apart);
    then each one's serving of 8 640x640 frames timed on every route
    (``serving_times``) and its postprocess per route
    (``phase_route_times``)."""
    out = {}
    for label, factory, grid in (("zoo_lite", lite_v5, 64), ("zoo_yaml", yaml_v5, 0)):
        models = build_shifted(factory, device, requests, label)
        served = serve_routes(models, requests, label)
        out[label] = dict(**served, unpaired=pair_routes_with_cpu(models, requests[1:2], label,
                                                                  grid))
        batch = frames(25, B, 640, 640)
        out[label]["times"] = serving_times(models, card, label, batch)
        out[label]["postprocess_times"] = phase_route_times(models, card, label, batch)
        del models
    return out


def phase_zoo_custom(tmp: str, device, card: str) -> dict:
    """(b) the non-standard checkpoint of tests/torch_fixture (an extra C3
    at flat index 14; 80 classes, fp16, random BatchNorm statistics)
    loaded by ``load_yaml_from_ultralytics`` on the card in both dtypes
    and on the CPU: served through the default route (exactly
    DEFAULT_PER_BATCH a batch), the card's float32 decode within the JAX
    test's tolerance of the fixture's torch oracle."""
    import torch

    from yolort_tpu_torch import YOLOv5
    from yolort_tpu_torch.models.yaml_model import load_yaml_from_ultralytics
    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    path = f"{tmp}/custom.pt"
    oracle = torch_fixture().make_custom_checkpoint(path, nc=80, seed=0)
    models = {dt: YOLOv5(model=load_yaml_from_ultralytics(path, device=device, dtype=dt,
                                                          score_thresh=0.25), dtype=dt)
              for dt in (torch.float32, torch.bfloat16)}
    cpu = YOLOv5(model=load_yaml_from_ultralytics(path, device="cpu"))
    req = frames(19, 2, 480, 640)
    reset_launch_counts()
    for dt, m in models.items():
        print(f"[zoo_yaml] custom checkpoint {dt} served: detections/img "
              f"{check_served([m(req)], f'custom checkpoint {dt}')}", flush=True)
    torch.cuda.synchronize()
    counts = {fn.__name__: fn.launches for fn in KERNELS}
    want = {k: DEFAULT_PER_BATCH.get(k, 0) * len(models) for k in counts}
    if counts != want:
        raise AssertionError(f"custom checkpoint: launches {counts}, want {want}")
    canvas = cpu.canvas(torch.from_numpy(np.stack(req[:1])))[0]
    with torch.inference_mode():
        dec = models[torch.float32].model.decode(canvas.to(device)).cpu().numpy()
        ref = oracle_hwa(oracle, canvas, cpu.model.head_outputs(canvas), 85)
    bad = ~np.isclose(dec, ref, rtol=2e-3, atol=2e-2)
    bad[..., 4:] |= np.abs(dec[..., 4:] - ref[..., 4:]) > 2e-3
    err = float(np.abs(dec - ref).max())
    if bad.any():
        raise AssertionError(f"custom checkpoint: card decode differs from the torch oracle at "
                             f"{int(bad.sum())} values (max abs {err})")
    print(f"[zoo_yaml] custom checkpoint {tuple(canvas.shape[1:3])}: card decode vs torch oracle "
          f"max abs {err:.3e} (rtol 2e-3, atol 2e-2, scores 2e-3) | {card}", flush=True)
    return counts


def check_detections(det, label: str) -> list:
    """Every image of a Detections batch carries finite detections."""
    import torch

    num = det.num.cpu()
    if not (num > 0).all():
        raise AssertionError(f"{label}: an image has no detections ({num.tolist()})")
    if not (torch.isfinite(det.boxes).all() and torch.isfinite(det.scores).all()):
        raise AssertionError(f"{label}: non-finite detections")
    return num.tolist()


def phase_ensemble_tta(models_s, device, card: str) -> dict:
    """(c) ``Ensemble`` of yolov5s (phase 4's models) and yolov5m (seeded,
    head biases shifted the same way) at full width, and ``tta_inference``
    of yolov5s (scales 1, 0.83, 0.67; the middle one flipped), on a batch
    of 8 letterboxed 640x640 canvases, both dtypes and configs, once per
    route, each route's counts set to 0 just before and read just after:
    exactly FLATTEN_KERNELS a batch (the decoded path: bisect_count 2, the
    route's fetch kernel 2, nms_mask 1), every image with detections,
    each route's Detections equal to the default route's; the card's
    postprocess of the pooled predictions paired with the CPU's on a
    2-image batch; then the batch time (CUDA events), the device-busy time
    of a call (profiler) and the postprocess's time per route."""
    import torch

    import yolort_tpu_torch
    from yolort_tpu_torch.models.ensemble import Ensemble
    from yolort_tpu_torch.models.tta import tta_decode, tta_inference
    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    batch = frames(24, B, 640, 640)
    models_m = build_shifted(yolort_tpu_torch.yolov5m, device, [batch], "ensemble")
    cases = {}
    for dt, m5 in models_s.items():
        s, canvas = m5.model, m5.canvas(torch.from_numpy(np.stack(batch)).to(device))[0]
        ens = Ensemble([s, models_m[dt].model])
        cases[("ensemble", dt)] = (s, canvas, ens, ens.decode)
        cases[("tta", dt)] = (s, canvas, lambda c, s=s: tta_inference(s, c),
                              lambda c, s=s: tta_decode(s, c))
    configs = (("eval", EVAL), ("serving", SERVING))
    out = {}
    for path in ("ensemble", "tta"):
        runs = [(dt, name, cfg) for dt in models_s for name, cfg in configs]
        launches, dets = {}, {}
        for route in ROUTES:
            reset_launch_counts()
            for dt, name, cfg in runs:
                lead, canvas, run, _ = cases[(path, dt)]
                lead.row_gather = route
                lead.score_thresh, lead.pre_nms_topk = cfg["score_thresh"], cfg["pre_nms_topk"]
                with torch.inference_mode():
                    dets[(route, dt, name)] = run(canvas)
            torch.cuda.synchronize()
            counts = {fn.__name__: fn.launches for fn in KERNELS}
            want = {k: FLATTEN_KERNELS[route].get(k, 0) * len(runs) for k in counts}
            print(f"[{path}] route {route}: launches over {len(runs)} batches of {B} {counts}",
                  flush=True)
            if counts != want:
                raise AssertionError(f"{path} route {route}: launches {counts}, want {want}")
            launches[route] = counts
        for (route, dt, name), det in dets.items():
            n = check_detections(det, f"{path} {route} {dt} {name}")
            if route == DEFAULT_ROUTE:
                print(f"[{path}] {str(dt):>14} {name:>7}: detections/img {n}", flush=True)
            elif not all(torch.equal(a, b) for a, b in zip(det, dets[(DEFAULT_ROUTE, dt, name)])):
                raise AssertionError(f"{path} {route} {dt} {name}: Detections differ from the "
                                     f"default route's")
        print(f"[{path}] every route gave the default route's Detections exactly", flush=True)

        unpaired, times = 0, {}
        for dt, name, cfg in runs:
            lead, canvas, run, decode = cases[(path, dt)]
            lead.score_thresh, lead.pre_nms_topk = cfg["score_thresh"], cfg["pre_nms_topk"]
            lead.row_gather = DEFAULT_ROUTE
            with torch.inference_mode():
                pooled2 = decode(canvas[:2])
                un = pair_detections(lead.postprocess_decoded(pooled2),
                                     lead.postprocess_decoded(pooled2.cpu()),
                                     f"{path} {dt} {name}")
                unpaired += un
                pooled = decode(canvas)
                batch_ms = median_ms(lambda: run(canvas), 5, 3)
                busy = device_profile(lambda: run(canvas), iters=3)[0]
                line = []
                for route in ROUTES:
                    lead.row_gather = route
                    ev = median_ms(lambda: lead.postprocess_decoded(pooled), 5, 3)
                    dev = device_profile(lambda: lead.postprocess_decoded(pooled), iters=3)[0]
                    times[(str(dt), name, route)] = (ev, dev)
                    line.append(f"{route} {ev:.3f} ms (device {fmt_ms(dev)})")
                lead.row_gather = DEFAULT_ROUTE
            times[(str(dt), name)] = dict(batch_ms=batch_ms, device_busy_ms=busy,
                                          anchors=int(pooled.shape[1]))
            share = f"{100 * busy / batch_ms:.1f}%" if busy else "not measured"
            print(f"[{path}] {dt} {name} batch {B} @640x640 ({pooled.shape[1]} pooled anchors): "
                  f"{batch_ms:.2f} ms a batch (CUDA events, median of 5), {B / batch_ms * 1e3:.1f} "
                  f"images/s, device busy {fmt_ms(busy)} ({share}); card vs CPU on 2 images: "
                  f"{un} unpaired; postprocess by route {'; '.join(line)} | {card}", flush=True)
        totals = {k: sum(launches[r][k] for r in ROUTES) for k in launches[DEFAULT_ROUTE]}
        out[path] = dict(launches=totals, unpaired=unpaired, times=times)
    for m5 in models_s.values():
        m5.model.score_thresh, m5.model.pre_nms_topk = SERVING["score_thresh"], SERVING["pre_nms_topk"]
    del models_m
    return out


# --------------------------------------------------------------------------
# phase 9: training
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# phase 11: int8, the rest (grouped and ReLU convs, the AP harness)
# --------------------------------------------------------------------------

# grouped convs beside yolo_lite's, (Cin, Cout, groups, k, stride, input
# side, act): DWConv(96, 64, 5) and the cheap halves of a C3Ghost(128,
# 128)'s GhostBottleneck at 80x80
EXTRA_GROUPED = ((96, 64, 32, 5, 1, 40, "none"), (16, 16, 16, 5, 1, 80, "silu"),
                 (32, 32, 32, 5, 1, 80, "none"))
QCONV_NAMES = ("qconv1x1", "qconv_kxk", "qconv_grouped")


def poisoned(call, dtype):
    """``call()`` with every ``torch.empty`` it makes filled first with a
    value no output takes: int8 -128 (the kernels clamp to -127), float
    NaN.  An output the kernel skips then differs from the plain version."""
    import torch

    empty = torch.empty

    def fill(*args, **kwargs):
        x = empty(*args, **kwargs)
        x.untyped_storage().fill_(0x80 if dtype == torch.int8 else 0xFF)
        return x

    torch.empty = fill
    try:
        return call()
    finally:
        torch.empty = empty


def quantized_convs(model):
    from yolort_tpu_torch.ops.blocks import Conv, Conv2dOnly

    return [m for m in model.modules() if isinstance(m, (Conv, Conv2dOnly)) and m.quantized]


def conv_calls(qmodel, canvas) -> dict:
    """{key: [module, its input, launches a forward]} of every quantized
    conv of ``qmodel.head_outputs(canvas)``, one entry a distinct shape and
    activation: key (kernel, k, stride, pad, groups, Cin, Cout, H, W, act,
    float out)."""
    import torch

    seen = {}

    def hook(mod, inputs, output):
        x = inputs[0]
        _, cin, h, w = (x.q if hasattr(x, "q") else x).shape
        key = (kernel_of(mod, cin), mod.k, mod.s, mod.pad, mod.g, cin, mod.wq.shape[0], h, w,
               getattr(mod, "act", "none"), mod.os is None)
        seen.setdefault(key, [mod, x, 0])[2] += 1

    hooks = [m.register_forward_hook(hook) for m in quantized_convs(qmodel)]
    try:
        with torch.inference_mode():
            qmodel.head_outputs(canvas)
    finally:
        for h in hooks:
            h.remove()
    return seen


def conv_launches(qmodel, canvas) -> dict:
    """The qconv kernel launches of one forward, from the convs it calls
    (every quantized conv exactly once)."""
    calls = conv_calls(qmodel, canvas)
    if sum(n for _, _, n in calls.values()) != len(quantized_convs(qmodel)):
        raise AssertionError("a quantized conv ran other than once a forward")
    out = {}
    for key, (_, _, n) in calls.items():
        out[key[0]] = out.get(key[0], 0) + n
    return out


def check_qconv_shape(label: str, name: str, run, plain, dtypes) -> dict:
    """Kernel against plain version in each out dtype (outputs poisoned),
    bit for bit; then the network's own kind (the first) timed."""
    import torch

    from yolort_tpu_torch.ops import cuda

    fn = getattr(cuda, name)
    outs = {}
    with torch.inference_mode():
        for dt in dtypes:
            before = fn.launches
            got = outs[dt] = poisoned(lambda: run(dt), dt)
            want = plain(dt)
            torch.cuda.synchronize()
            if fn.launches != before + 1:
                raise AssertionError(f"{label}: {name} did not launch")
            if got.dtype != want.dtype or not torch.equal(got, want):
                raise AssertionError(f"{label} {dt}: {name} differs from its plain version")
        dt = dtypes[0]
        gms = graph_ms(lambda: run(dt))
        ms = median_ms(lambda: run(dt), 10, 3)
        pms = median_ms(lambda: plain(dt), 2, 3)
    return dict(graph_ms=gms, ms=ms, plain_ms=pms, out=outs[dt])


def phase_lite_int8_kernels(qmodel, canvas, card: str) -> dict:
    """(a) Every distinct quantized conv shape of yolo_lite @640 at batch 8
    with ``min_reduce=1`` (the stem, every depth-wise 3x3 / 5x5 at strides
    1 and 2 on qconv_grouped, the ReLU expand 1x1s), on the network's own
    activations, and DWConv(96, 64, 5) and a C3Ghost's cheap halves on
    seeded int8: each kernel against its plain version in int8, float32
    and bfloat16 out, outputs poisoned first, bit for bit; each shape's
    device time (CUDA-graph replay) beside its bound (bytes in and out at
    the card's bandwidth, or int8 operations) and its plain version's."""
    import torch

    from yolort_tpu_torch.ops.blocks import inv_scale
    from yolort_tpu_torch.ops.cuda import qconv, qconv_grouped_reference
    from yolort_tpu_torch.ops.cuda.qconv_kernel import pack_weight

    at = f"B={canvas.shape[0]} @{canvas.shape[1]}x{canvas.shape[2]}"
    res = {n: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, graph_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                   ops_ms=0.0, shapes=0, launches_per_forward=0, weighted_graph_ms=0.0,
                   weighted_bound_ms=0.0, relu_shapes=0) for n in QCONV_NAMES}
    jobs = []
    for key, (mod, xin, n_fwd) in sorted(conv_calls(qmodel, canvas).items(), key=str):
        name, k, s, pad, g, cin, cout, h, w, act, float_out = key
        xq, scale, bias, os, ft = mod.qconv_operands(xin)
        inv = None if os is None else inv_scale(os)
        kinds = (ft,) if float_out else (torch.int8, torch.float32, torch.bfloat16)
        conv = dict(k=k, stride=s, pad=pad, groups=g, act=act)

        def run(dt, xq=xq, wq=mod.wq, scale=scale, bias=bias, inv=inv, conv=conv):
            return qconv(xq, wq, scale, bias, inv_out_scale=inv if dt == torch.int8 else None,
                         out_dtype=torch.float32 if dt == torch.int8 else dt, **conv)

        def plain(dt, mod=mod, xq=xq, scale=scale, bias=bias, inv=inv, act=act):
            return plain_qconv(mod, xq, scale, bias, act=act,
                               inv_out_scale=inv if dt == torch.int8 else None,
                               out_dtype=torch.float32 if dt == torch.int8 else dt)

        jobs.append((name, f"{k}x{k}/s{s} g{g} {cin}->{cout} @{h}x{w} {act}", run, plain, kinds,
                     xq, mod.wq, n_fwd, k * k * (cin // g)))
    rng = np.random.default_rng(31)
    for cin, cout, g, k, s, side, act in EXTRA_GROUPED:
        b = canvas.shape[0]
        xq = torch.from_numpy(rng.integers(-127, 128, (b, side, side, cin), dtype=np.int8))
        xq = xq.to(canvas.device).permute(0, 3, 1, 2)
        wq = pack_weight(rng.integers(-127, 128, (k, k, cin // g, cout), dtype=np.int8)).to(
            canvas.device)
        scale = torch.from_numpy(rng.uniform(1e-5, 1e-4, cout).astype(np.float32)).to(canvas.device)
        bias = torch.from_numpy(rng.uniform(-2, 2, cout).astype(np.float32)).to(canvas.device)
        conv = dict(k=k, stride=s, groups=g, act=act)

        def run(dt, xq=xq, wq=wq, scale=scale, bias=bias, conv=conv):
            return qconv(xq, wq, scale, bias, inv_out_scale=30.0 if dt == torch.int8 else None,
                         out_dtype=torch.float32 if dt == torch.int8 else dt, **conv)

        def plain(dt, xq=xq, wq=wq, scale=scale, bias=bias, conv=conv):
            return qconv_grouped_reference(xq, wq, scale, bias,
                                           inv_out_scale=30.0 if dt == torch.int8 else None,
                                           out_dtype=torch.float32 if dt == torch.int8 else dt,
                                           **conv)

        jobs.append(("qconv_grouped", f"{k}x{k}/s{s} g{g} {cin}->{cout} @{side}x{side} {act} "
                     f"(seeded)", run, plain, (torch.int8, torch.float32, torch.bfloat16), xq, wq,
                     0, k * k * (cin // g)))
    for name, what, run, plain, kinds, xq, wq, n_fwd, depth in jobs:
        t = check_qconv_shape(f"[int8 rest] {what}", name, run, plain, kinds)
        out = t.pop("out")
        nbytes = xq.numel() + wq.numel() + 8 * wq.shape[0] + out.numel() * out.element_size()
        ops = 2.0 * out.numel() * depth
        bms, by = bound(nbytes, ops, "int8")
        r = res[name]
        for key in ("ms", "plain_ms", "graph_ms"):
            r[key] += t[key]
        r["bound_ms"] += bms
        r["bytes_ms"] += bound(nbytes)[0]
        r["ops_ms"] += ops / PEAK_OPS_PER_S["int8"] * 1e3
        r["shapes"] += 1
        r["relu_shapes"] += " relu" in what
        r["launches_per_forward"] += n_fwd
        r["weighted_graph_ms"] += n_fwd * t["graph_ms"]
        r["weighted_bound_ms"] += n_fwd * bms
        print(f"[int8 rest] {name} {at} {what} -> {out.dtype} x{n_fwd} a forward: bit-identical in "
              f"{len(kinds)} out kinds, outputs poisoned; kernel device {t['graph_ms']:.4f} ms "
              f"(graph replay), events {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms; bound "
              f"{bms:.4f} ms ({by}: {nbytes / 1e6:.2f} MB in and out), "
              f"{100 * bms / t['graph_ms']:.1f}% of bound | {card}", flush=True)
    for name, r in res.items():
        if not r["shapes"]:
            raise AssertionError(f"int8 rest: no conv ran on {name}")
        r["bound_by"] = "operations" if r.pop("ops_ms") > r.pop("bytes_ms") else "bytes"
        r["at"] = f"yolo_lite min_reduce=1 {at}, sum over {r['shapes']} distinct shapes"
        print(f"[int8 rest] {name} yolo_lite {at}: {r['shapes']} shapes ({r['relu_shapes']} ReLU) "
              f"once each: kernel device {r['graph_ms']:.4f} ms (graph replay), plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); a forward "
              f"({r['launches_per_forward']} launches): {r['weighted_graph_ms']:.4f} ms, bound "
              f"{r['weighted_bound_ms']:.4f} ms | {card}", flush=True)
    res["qconv_grouped"].update(library_ms=None, library_call="none (no int8 CUDA conv in core "
                                                              "PyTorch)")
    return res


def lite_int8(device, requests, card: str) -> tuple:
    """yolo_lite (80 classes, seeded, head biases shifted to phase 4's
    candidate load) calibrated on the card on 4 batches of 2 640x640
    frames, then quantized under the default recipe and under
    ``min_reduce=1``, each finalized.  Returns ({label: quantized model},
    the batch-8 canvas)."""
    import torch

    from yolort_tpu_torch.ops.quantization import (
        calibrate_activations, finalize_scales, quantize_compute_params,
    )

    t0 = time.perf_counter()
    m = lite_v5(device=device, dtype=torch.float32, seed=0)
    delta = calibrate_candidate_density(m, requests)
    shift_head_bias(m.model, delta)
    x = torch.from_numpy(np.stack(frames(26, B, 640, 640))).to(device)
    with torch.inference_mode():
        canvas = m.canvas(x)[0]
    cal = [canvas[i:i + 2] for i in range(0, len(canvas), 2)]
    calibrate_activations(m.model, cal)
    out = {}
    for label, kw in (("int8_lite", {}), ("int8_lite_grouped", dict(min_reduce=1))):
        q = quantize_compute_params(m.model, **kw)
        finalize_scales(q, cal[0][:1])
        convs = quantized_convs(q)
        print(f"[{label}] yolo_lite head bias shift {delta:.4f}, recipe {kw or 'default'}: "
              f"{len(convs)} convs quantized, {sum(c.g > 1 for c in convs)} grouped, "
              f"{sum(getattr(c, 'act', '') == 'relu' for c in convs)} ReLU", flush=True)
        out[label] = q
    want = {"int8_lite": (41, 0, 0), "int8_lite_grouped": (61, 11, 5)}
    for label, q in out.items():
        convs = quantized_convs(q)
        got = (len(convs), sum(c.g > 1 for c in convs),
               sum(getattr(c, "act", "") == "relu" for c in convs))
        if got != want[label]:
            raise AssertionError(f"{label}: (quantized, grouped, ReLU) convs {got}, want "
                                 f"{want[label]} (the JAX recipe's)")
    print(f"[int8 rest] yolo_lite calibrated, quantized twice and finalized in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out, canvas


def lite_card_vs_cpu(qmodel, label: str) -> dict:
    """The card's int8 yolo_lite against the CPU run of the port on one
    480x640 frame letterboxed to 640: the head logits' largest difference
    (printed), then ``int8_witness`` conv by conv (each conv given the
    card's own input), which holds each kernel to its plain version and
    the CPU to the card but for one-level flips at a rounding boundary."""
    import copy

    import torch

    canvas = pair_canvas(64)
    device = next(qmodel.buffers()).device
    cpu_model = copy.deepcopy(qmodel).cpu()
    with torch.inference_mode():
        heads_gpu = qmodel.head_outputs(canvas.to(device))
        heads_cpu = cpu_model.head_outputs(canvas)
    err = max((hg.cpu() - hc).abs().max().item() for hg, hc in zip(heads_gpu, heads_cpu))
    top = max(hc.abs().max().item() for hc in heads_cpu)
    print(f"[{label}] card vs CPU, 1x480x640 float32 on a {tuple(canvas.shape[1:3])} canvas: head "
          f"logits max abs diff {err:.3e} (max |logit| {top:.3f})", flush=True)
    w = int8_witness(qmodel, canvas.to(device), label)
    return dict(head_err=err, head_max=top, witness_first=w["first"],
                witness_parted=sum(f[1] for f in w["forced"]))


def phase_lite_int8_served(qmodels: dict, requests, card: str) -> dict:
    """(b) Each int8 yolo_lite through ``YOLOv5(model=..., size_divisible=64)``
    on phase 4's requests in float32 and bfloat16 (a bfloat16 copy: the
    convs left float need bfloat16 weights) under both configs on every
    route: every route's detections equal to the default's, the qconv
    kernels exactly as many times a batch as the model has convs on each,
    the default route's postprocess kernels DEFAULT_PER_BATCH a batch;
    the card's postprocess paired with the CPU's on the 4x480x640 request
    (head outputs on a 1/64 grid, as phase 10 pairs yolo_lite); the card's
    network against the CPU's (``lite_card_vs_cpu``); images/s and device
    busy."""
    import copy

    import torch

    from yolort_tpu_torch import YOLOv5

    out = {}
    for label, q in qmodels.items():
        models = {dt: YOLOv5(model=q if dt == torch.float32 else copy.deepcopy(q).to(dt),
                             dtype=dt, size_divisible=64)
                  for dt in (torch.float32, torch.bfloat16)}
        canvas = models[torch.float32].canvas(
            torch.from_numpy(np.stack(requests[0][:1])).to(models[torch.float32].device))[0]
        convs = conv_launches(q, canvas)
        print(f"[{label}] qconv launches a forward {convs}", flush=True)
        served = serve_routes(models, requests, label, convs)
        out[label] = dict(**served, convs=convs,
                          unpaired=pair_routes_with_cpu(models, requests[1:2], label, 64),
                          card_vs_cpu=lite_card_vs_cpu(q, label))
        out[label]["times"] = serving_times(models, card, label, frames(25, B, 640, 640))
        del models
    return out


def phase_int8_ap(device, card: str) -> dict:
    """(c) The int8 AP harness on the card (utils/quant_probe.py): the nano
    scene detector trained 1000 steps, TF32 off, then ``int8_ap_report``
    (calibrate, quantize all, scan, skip worst first); the bounds of
    tests/test_int8_ap_delta.py must hold.  The launch counts are read
    over the whole harness."""
    import torch

    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
    from yolort_tpu_torch.utils import quant_probe as QP

    images, gts = QP.make_scenes()
    reset_launch_counts()
    t0 = time.perf_counter()
    model = QP.train_scene_detector(images, gts, steps=1000, device=device)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rep = QP.int8_ap_report(model, images, gts, target_delta=0.05)
    torch.cuda.synchronize()
    report_s = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in KERNELS}
    print(f"[int8_ap] TF32 off while the harness trains, calibrates, scans and evaluates "
          f"(quant_probe.full_float32), deterministic algorithms while it trains, init seed "
          f"{QP.SCENE_SEED}; outside it cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}, matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    print(f"[int8_ap] scene detector (yolov5n r6.0, 2 classes, 4 scenes {images.shape[1]}px) "
          f"trained 1000 Adam steps in {train_s:.1f} s ({1e3 * train_s / 1000:.2f} ms/step, host "
          f"clock); int8_ap_report in {report_s:.1f} s: {rep} | {card}", flush=True)
    print(f"[int8_ap] launches over the harness {launches}", flush=True)
    for kname in ("qconv1x1", "qconv_kxk", *DEFAULT_PER_BATCH):
        if launches[kname] <= 0:
            raise AssertionError(f"int8_ap: kernel {kname} was not launched")
    if rep["float_ap"] < 0.7:
        raise AssertionError(f"int8_ap: the scene detector did not converge: {rep}")
    if rep["int8_ap_all"] < 0.5 * rep["float_ap"]:
        raise AssertionError(f"int8_ap: int8 of every conv keeps under half the float AP: {rep}")
    if rep["delta"] > 0.05:
        raise AssertionError(f"int8_ap: the recipe's AP delta exceeds 0.05: {rep}")
    return dict(launches=launches, report=rep, train_s=train_s, report_s=report_s)


TRAIN_CFG = dict(lr=0.01, momentum=0.937, weight_decay=5e-4)
TRAIN_BATCH = 8
# card against CPU, one train step from the same params (TF32 off):
# loss terms relative, gradient and param leaves relative to the leaf's
# largest |value|.  Both run f32 with their own convolution algorithms and
# reduction orders through ~60 layers; the CPU tests hold the same
# quantities against JAX at 2e-5 (gradients) and 1e-6 (params).
TRAIN_TOL = {"loss": 1e-4, "grad": 1e-3, "param": 1e-5}


def synthetic_coco(seed: int, n: int, h: int = 480, w: int = 640, num_classes: int = 80):
    """An in-memory COCO-style set of ``n`` HxW float frames, each with 1-3
    filled rectangles drawn as ``data._helper.create_synthetic_coco`` draws
    them (dark noise, a class colour, both corners inclusive), without
    OpenCV; image i's first box is small, medium or large by i % 3 in the
    COCO area ranges, so every range holds boxes."""
    rng = np.random.default_rng(seed)
    colors = [(255, 64, 64), (64, 255, 64), (64, 64, 255)]
    sides = ((12, 30), (40, 90), (110, 240))
    items = []
    for i in range(n):
        img = rng.integers(0, 60, (h, w, 3)).astype(np.uint8)
        boxes, labels = [], []
        for j in range(int(rng.integers(1, 4))):
            lo, hi = sides[i % 3] if j == 0 else (12, 240)
            cls = int(rng.integers(0, num_classes))
            bw, bh = int(rng.integers(lo, hi)), int(rng.integers(lo, hi))
            x, y = int(rng.integers(0, w - bw)), int(rng.integers(0, h - bh))
            img[y:y + bh + 1, x:x + bw + 1] = colors[cls % 3]
            boxes.append([x, y, x + bw, y + bh])
            labels.append(cls)
        items.append((img.astype(np.float32) / 255.0,
                      {"boxes": np.asarray(boxes, np.float32), "labels": np.asarray(labels),
                       "iscrowd": np.zeros(len(boxes), np.int64), "orig_size": np.asarray([h, w])}))
    return items


def tree_errors(want: dict, got: dict, path: str = "") -> list:
    """(error relative to the leaf's largest |want|, path) of every leaf."""
    if set(want) != set(got):
        raise AssertionError(f"trees differ at {path}: {sorted(want)} vs {sorted(got)}")
    out = []
    for key, a in want.items():
        if isinstance(a, dict):
            out += tree_errors(a, got[key], f"{path}/{key}")
            continue
        scale = float(np.abs(a).max())
        err = float(np.abs(a - got[key]).max())
        out.append((err / scale if scale else err, f"{path}/{key}"))
    return out


def phase_train(device, card: str) -> dict:
    """yolov5s r6.0 at full width @640, f32, in its train form on the card:
    (a) one train step on the card against the CPU from the same params on
    one 2-image batch; (b) ten steps on one repeated batch of 8: every
    loss finite, the last total below the first, the step timed (and its
    device time by kernel, from the profiler); (c) fit
    for one epoch over 32 frames with the EMA and a checkpoint, validated
    on 8: exactly DEFAULT_PER_BATCH kernel launches per eval batch and
    finite COCO metrics; (d) the train state saved and loaded on the card
    gives back params, momentum buffers, step and schedule count bit for
    bit."""
    import torch

    from yolort_tpu_torch.data.data_module import DetectionDataModule
    from yolort_tpu_torch.models._bridge import params_from_jax, params_to_jax
    from yolort_tpu_torch.models.yolo import build_yolo
    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
    from yolort_tpu_torch.trainer.checkpoint import load_train_state, save_train_state
    from yolort_tpu_torch.trainer.fit import evaluate, fit
    from yolort_tpu_torch.trainer.task import DefaultTask, TrainState

    arch = "yolov5_darknet_pan_s_r60"
    data = synthetic_coco(30, 32)
    dm_kw = dict(canvas_hw=(640, 640), min_size=640, max_size=640, max_targets_per_image=8)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    print(f"[train] TF32 matmul {torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # (a) card against CPU, one train step
    pair = next(DetectionDataModule(data[:2], batch_size=2, **dm_kw).batches())
    grads, after, losses = {}, {}, {}
    start = None
    for side, dev in (("card", device), ("cpu", torch.device("cpu"))):
        task = DefaultTask(build_yolo(arch, device=dev), **TRAIN_CFG)
        if start is None:
            state = task.init_state(0)
            start = params_to_jax(task.model)
        else:
            params_from_jax(start, task.model).trainable()
            state = TrainState(task.model, *task.make_optimizer())
        t0 = time.perf_counter()
        state, metrics = task.train_step(state, *(torch.from_numpy(pair[k]).to(dev)
                                                  for k in ("images", "targets", "target_mask")))
        losses[side] = {k: float(v) for k, v in metrics.items()}
        print(f"[train] one step of 2 on the {side}: {time.perf_counter() - t0:.2f} s "
              f"{losses[side]}", flush=True)
        grads[side] = params_to_jax(task.model, leaf=lambda q: q.grad)
        after[side] = params_to_jax(task.model)
    report = {"loss": max((abs(losses["card"][k] - v) / abs(v), k) for k, v in losses["cpu"].items()),
              "grad": max(tree_errors(grads["cpu"], grads["card"])),
              "param": max(tree_errors(after["cpu"], after["card"]))}
    for what, (err, where) in report.items():
        print(f"[train] card vs CPU {what}: worst {where} at {err:.3g} (tolerance "
              f"{TRAIN_TOL[what]:g})", flush=True)
        if not err <= TRAIN_TOL[what]:
            raise AssertionError(f"train step: card {what} {where} off the CPU's by {err:.3g}")
    del grads, after, task, state

    # (b) ten steps on one repeated batch; steps 3-10 timed
    task = DefaultTask(build_yolo(arch, device=device), **TRAIN_CFG)
    state = task.init_state(1)
    batch = next(DetectionDataModule(data, batch_size=TRAIN_BATCH, **dm_kw).batches())
    bi, bt, bm = (torch.from_numpy(batch[k]).to(device) for k in ("images", "targets", "target_mask"))
    totals = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for i in range(10):
        if i == 2:
            events[0].record()
        state, metrics = task.train_step(state, bi, bt, bm)
        totals.append(metrics["total"])
    events[1].record()
    torch.cuda.synchronize()
    step_ms = events[0].elapsed_time(events[1]) / 8
    peak = torch.cuda.max_memory_allocated()
    totals = [float(t) for t in totals]
    print(f"[train] repeated batch of {TRAIN_BATCH}: totals {[round(t, 5) for t in totals]}",
          flush=True)
    if not all(np.isfinite(totals)) or not totals[-1] < totals[0]:
        raise AssertionError(f"train: loss on a repeated batch {totals}")
    print(f"[train] step at batch {TRAIN_BATCH} @640 f32: {step_ms:.2f} ms (CUDA events, steps 3-10) "
          f"| {card}", flush=True)
    print(f"[train] images/s: {TRAIN_BATCH * 1e3 / step_ms:.1f} | {card}", flush=True)
    print(f"[train] max_memory_allocated: {peak / 2**30:.3f} GiB | {card}", flush=True)
    busy, rows = device_profile(lambda: task.train_step(state, bi, bt, bm), iters=3)
    if busy is not None:
        print(f"[train] device busy a step (profiler): {busy:.2f} ms, {100 * busy / step_ms:.1f}% of "
              f"the events' step; top kernels: " + "; ".join(
                  f"{name[:80]} {ms:.3f}" for name, ms in rows[:10]) + f" | {card}", flush=True)
    del task, state, bi, bt, bm

    # (c) fit, one epoch with the EMA, validated through the serving kernels
    steps = len(data) // TRAIN_BATCH
    task = DefaultTask(build_yolo(arch, device=device), total_steps=2 * steps, warmup_steps=1,
                       **TRAIN_CFG)
    train = DetectionDataModule(data, batch_size=TRAIN_BATCH, shuffle=True, seed=0, **dm_kw)
    val = DetectionDataModule(data[:8], batch_size=TRAIN_BATCH, **dm_kw)
    with tempfile.TemporaryDirectory() as tmp:
        reset_launch_counts()
        t0 = time.perf_counter()
        state = fit(task, train, val, max_epochs=1, seed=2, use_ema=True,
                    checkpoint_path=f"{tmp}/ema.npz", print_freq=1)
        torch.cuda.synchronize()
        counts = {fn.__name__: fn.launches for fn in KERNELS}
        print(f"[train] fit, 1 epoch of {steps} steps + eval: {time.perf_counter() - t0:.2f} s; "
              f"launches {counts}", flush=True)
        want = {k: DEFAULT_PER_BATCH.get(k, 0) * len(val) for k in counts}
        if counts != want:
            raise AssertionError(f"train eval launches {counts}, want {want}")
        # fit's model now holds the EMA params its evaluation served
        results = evaluate(state.model, val, val.canvas_hw)
        print(f"[train] COCO metrics of the EMA model: {results}", flush=True)
        if not results or not all(np.isfinite(v) for v in results.values()):
            raise AssertionError(f"train eval: COCO metrics not finite: {results}")
        if state.step != steps:
            raise AssertionError(f"train: {state.step} steps, want {steps}")

        # (d) the train state, saved and loaded on the card
        save_train_state(f"{tmp}/state.npz", state, {"epoch": 0})
        back_task = DefaultTask(build_yolo(arch, device=device), total_steps=2 * steps,
                                warmup_steps=1, **TRAIN_CFG)
        back, meta = load_train_state(f"{tmp}/state.npz", back_task)
        same = (back.step == state.step and meta == {"epoch": 0}
                and back.scheduler.last_epoch == state.scheduler.last_epoch
                and all(torch.equal(a, b) for a, b in zip(back.model.parameters(),
                                                          state.model.parameters(), strict=True))
                and all(torch.equal(back.optimizer.state[a]["momentum_buffer"],
                                    state.optimizer.state[b]["momentum_buffer"])
                        for a, b in zip(back.model.parameters(), state.model.parameters())))
        if not same:
            raise AssertionError("train state: save and load on the card did not give it back")
        print(f"[train] train state saved and loaded on the card: params, momentum, step "
              f"{back.step} and schedule count {back.scheduler.last_epoch} bit for bit", flush=True)
    return dict(launches=counts, step_ms=step_ms, peak=peak, report=report)


def main() -> int:
    import torch

    card = phase_device()
    import yolort_tpu_torch  # (fails outside a checkout)
    from yolort_tpu_torch import YOLOv5

    device = torch.device("cuda", 0)
    t0 = time.perf_counter()

    def done(phase: str) -> None:
        print(f"[wall] {phase} done at {time.perf_counter() - t0:.1f} s", flush=True)

    phase_build()
    done("build")
    res = phase_kernels(device, card)
    for name, r in phase_postprocess_kernels(device, card).items():
        res.setdefault(name, {}).update(r)
    res.update(phase_sweep_kernels(device, card))
    for name, extra in (*phase_p6_kernels(device, card).items(),
                        *phase_zoo_kernels(device, card).items()):
        res[name].update(extra)
    done("kernels")
    sl = phase_slice(device, card)
    done("slice")
    batch = frames(20, 32, 640, 640)
    fmodel = yolort_tpu_torch.yolov5s(device=device, dtype=torch.float32, seed=0)
    qmodel = build_int8(fmodel, device, sl["requests"], batch, "int8")
    res.update(phase_qconv_kernels(qmodel, fmodel, batch, B, device, card))
    done("int8 build and qconv kernels")
    q8 = phase_int8_slice(qmodel, sl["requests"], device, card)
    done("int8 slice")
    flat = phase_flatten_paths(sl["models"], sl["requests"], card)
    done("classes_per_anchor and decoded paths")
    fx = phase_fixed_shape(sl["models"], device, card)
    done("fixed_shape")
    r31, r31_launches = phase_r31_int8(device, sl["requests"], card)
    for name, r in r31.items():
        res[name]["r31"] = r
    done("r3.1 int8")
    p6 = phase_p6(device, card)
    done("p6 slice")
    phase_p6_int8_seeded(device, p6["requests"])
    done("p6 int8 seeded")
    with tempfile.TemporaryDirectory() as tmp:
        # P6 int8 served on the fabricated yolov5s6 checkpoint's weights:
        # on the seeded ones one flip spreads to thousands of values
        # (phase_p6_int8_seeded)
        made = {"s6 r6.0": fabricate(tmp, "s6 r6.0")}
        path = made["s6 r6.0"][0]
        fmodel6 = YOLOv5.load_from_yolov5(path, device=device, size=P6_SIZE, size_divisible=64)
        batch6 = frames(22, 8, 1280, 1280)
        qmodel6 = build_int8(fmodel6, device, p6["requests"], batch6, "p6 int8")
        for name, r in phase_qconv_kernels(qmodel6, fmodel6, batch6, 4, device, card).items():
            res[name]["p6"] = r
        q86 = phase_int8_slice(qmodel6, p6["requests"], device, card, "p6 int8", size=P6_SIZE,
                               size_divisible=64)
        del qmodel6, fmodel6, q86["models"]
        done("p6 int8")
        ck = phase_checkpoints(tmp, made, device, card)
        done("checkpoints")
        zoo = phase_zoo_served(device, sl["requests"], card)
        custom = phase_zoo_custom(tmp, device, card)
        done("zoo: yolo_lite and yaml")
    ens_tta = phase_ensemble_tta(sl["models"], device, card)
    done("zoo: ensemble and tta")
    lite_q, lite_canvas = lite_int8(device, sl["requests"], card)
    for name, r in phase_lite_int8_kernels(lite_q["int8_lite_grouped"], lite_canvas,
                                           card).items():
        if name in res:
            res[name]["lite"] = r
        else:
            res[name] = r
    del lite_canvas
    done("int8 rest: kernels")
    lite_served = phase_lite_int8_served(lite_q, sl["requests"], card)
    del lite_q
    done("int8 rest: yolo_lite int8 served")
    int8_ap = phase_int8_ap(device, card)
    done("int8 rest: AP harness")
    tr = phase_train(device, card)
    done("train")
    phase_throughput(sl["models"], card, "float")
    phase_throughput(q8["models"], card, "int8")
    phase_route_times(sl["models"], card)
    serving_times(p6["models"], card, "yolov5s6", frames(21, 8, 1280, 1280))
    done("times")
    paths = {"float": sl["launches"], "int8": q8["launches"], "cpa": flat["cpa"]["launches"],
             "decoded": flat["decoded"]["launches"], "fixed_shape": fx["launches"],
             "r31_int8": r31_launches, "p6": p6["launches"], "p6_int8": q86["launches"],
             "checkpoint": ck["launches"], "train_eval": tr["launches"],
             "zoo_lite": zoo["zoo_lite"]["launches"],
             "zoo_yaml": {k: n + custom[k] for k, n in zoo["zoo_yaml"]["launches"].items()},
             "ensemble": ens_tta["ensemble"]["launches"], "tta": ens_tta["tta"]["launches"],
             "int8_lite": lite_served["int8_lite"]["launches"],
             "int8_lite_grouped": lite_served["int8_lite_grouped"]["launches"],
             "int8_ap": int8_ap["launches"], **phase_entry_points()}
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
