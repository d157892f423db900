"""Stage-wise times of the inference pipeline, on the card unless the
caller passes ``--device cpu``.

    python -m yolort_tpu_torch.tools.profile_stages [--arch yolov5_darknet_pan_s_r60]
        [--batch 32] [--size 640] [--dtype float32|bfloat16] [--topk 4096] [--score S]
        [--calibrate] [--stages head,decode,topk,postprocess,cells,full]
        [--row_gather pallas_bisect|pallas_lookup|pallas_full] [--device cuda]

Port of ``tools/profile_stages.py``.  Each row times one function of the
port on a batch of random images (seeded), warm, ``ITERS`` times:

  * ``head``: ``backbone+pan+head`` (``head_outputs``); ``decode``:
    ``+decode``; ``topk``: ``decode-out topk(k=...)``, ``torch.topk`` of
    the decoded pair scores; ``postprocess``: ``batched_postprocess`` of
    the decoded predictions; ``full``: ``full pipeline`` (the model's
    forward on the letterboxed batch), with images/s;
  * ``cells``: the cumulative prefixes of the cell-major postprocess
    (``cell_prefixes``) on the network's head outputs, each calling the
    port's own functions of ``ops/nms.py`` as ``batched_postprocess_from_heads``
    does; the difference of two consecutive rows is a stage's cost, and
    the last prefix's detections are held against
    ``batched_postprocess_from_heads``' on the same heads (``bit_equal``).

Times: on the card CUDA events around each of ``ITERS`` back-to-back calls
(host gaps included), their median and minimum; on the CPU the host
clock.  Each row also counts the kernel launches of one call.
``--calibrate`` shifts the head's objectness and class biases until every
image has at least 120 pairs above 0.25, the bench's candidate load
(``utils.profiling.calibrate_candidate_density``).  The JAX tool's TPU
options (the ``nms_impl`` rows, ``--pallas``, the compiler options) have
no counterpart.  ``cli_main`` returns the rows.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

STAGES = ("head", "decode", "topk", "postprocess", "cells", "full")
ITERS = 10
WARMUP = 2


def parse_args(argv=None):
    from yolort_tpu_torch.ops.select import ROW_GATHERS

    ap = argparse.ArgumentParser("yolort_tpu_torch stage profiler")
    ap.add_argument("--arch", default="yolov5_darknet_pan_s_r60")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=640)
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--topk", type=int, default=4096)
    ap.add_argument("--score", type=float, default=None,
                    help="score threshold of the postprocess rows (default the model's, 0.005); "
                         "0.25 with --topk 512 is the serving config")
    ap.add_argument("--calibrate", action="store_true",
                    help="shift the head biases to the bench's candidate load")
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--row_gather", default="pallas_bisect", choices=ROW_GATHERS)
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def timed(fn: Callable, label: str, device: torch.device) -> Dict:
    """One row: ``fn`` warmed up ``WARMUP`` times, its launches in one call,
    then ``ITERS`` calls timed (module docstring); prints the row."""
    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts

    cuda = device.type == "cuda"
    for _ in range(WARMUP):
        fn()
    if cuda:
        torch.cuda.synchronize(device)
    reset_launch_counts()
    fn()
    if cuda:
        torch.cuda.synchronize(device)
    launches = {f.__name__: f.launches for f in KERNELS if f.launches}
    if cuda:
        marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(ITERS)]
        for a, b in marks:
            a.record()
            fn()
            b.record()
        torch.cuda.synchronize(device)
        ts = [a.elapsed_time(b) for a, b in marks]
    else:
        ts = []
        for _ in range(ITERS):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
    row = dict(label=label, ms=float(np.median(ts)), min_ms=float(np.min(ts)), launches=launches)
    print(f"{label:45s} {row['ms']:9.3f} ms  (min {row['min_ms']:.3f})  launches {launches}",
          flush=True)
    return row


def cell_prefixes(model, heads) -> List[Tuple[str, Callable]]:
    """[(label, fn)] of the cumulative prefixes of the cell-major
    postprocess of ``heads`` under ``model``'s configuration, in the order
    ``batched_postprocess_from_heads`` runs them; the last returns its
    ``Detections``."""
    from yolort_tpu_torch.ops import nms as N
    from yolort_tpu_torch.ops.cuda.stage1_kernel import fused_cells_stage1
    from yolort_tpu_torch.ops.select import select_topk_indices, select_topk_threshold

    cfg = N.NMSConfig(
        num_classes=model.num_classes, num_anchors=model.num_anchors,
        grid_sizes=tuple((int(h.shape[1]), int(h.shape[2])) for h in heads),
        strides=model.strides, anchor_grids=model.anchor_grids,
        score_thresh=model.score_thresh, nms_thresh=model.nms_thresh,
        detections_per_img=model.detections_per_img, pre_nms_topk=model.pre_nms_topk,
        pre_nms_anchors=model.pre_nms_anchors, nms_tile_size=model.nms_tile_size,
        row_gather=model.row_gather)
    A, nc = cfg.num_anchors, cfg.num_classes
    kw = 5 + nc
    bsz = heads[0].shape[0]
    na = sum(h * w for h, w in cfg.grid_sizes) * A
    k = min(cfg.pre_nms_topk, na * nc)
    k1 = min(cfg.pre_nms_anchors if cfg.pre_nms_anchors is not None else k + 8, na)
    k2 = min(k, k1 * nc)
    thr = N._f32(cfg.score_thresh)

    def stage1():
        cells, obj, cls = fused_cells_stage1(heads, A, kw)
        return cells, N._stage1_scores(obj, cls).reshape(bsz, -1)

    def stage1_select():
        cells, per_anchor = stage1()
        s1_ok, anchor_sel = select_topk_indices(per_anchor.float(), k1)
        return cells, s1_ok, anchor_sel

    def segment_gather():
        cells, s1_ok, anchor_sel = stage1_select()
        seg = torch.gather(cells.reshape(bsz, na, kw), 1,
                           anchor_sel[..., None].expand(-1, -1, kw))
        return seg, s1_ok, anchor_sel

    def decode():
        seg, s1_ok, anchor_sel = segment_gather()
        sel_sig = torch.sigmoid(seg.float())
        return N._stage2_scores(sel_sig, s1_ok, nc), N._decode_boxes(sel_sig, anchor_sel, cfg)

    def pair_select():
        scores, boxes = decode()
        top_scores, top_idx = select_topk_threshold(scores.reshape(bsz, -1), k2, thr,
                                                    row_gather=cfg.row_gather)
        return top_scores, top_idx, boxes

    def nms():
        top_scores, top_idx, boxes = pair_select()
        cand_boxes = torch.gather(boxes, 1, (top_idx // nc)[..., None].expand(-1, -1, 4))
        return N._nms_and_compact(
            cand_boxes, top_scores, (top_idx % nc).to(torch.int32), top_scores > thr,
            nms_thresh=N._f32(cfg.nms_thresh), detections_per_img=cfg.detections_per_img,
            nms_tile_size=cfg.nms_tile_size)

    return [("cells concat + stage-1", stage1),
            ("+ stage-1 select (bisect)", stage1_select),
            ("+ segment gather", segment_gather),
            ("+ seg extract + box decode", decode),
            ("+ stage-2 pair select", pair_select),
            ("+ box gather + NMS + compact", nms)]


def build(args):
    """(model, letterboxed images) of the arguments: ``args.arch`` seeded on
    ``args.device`` in ``args.dtype``, its head biases shifted where
    ``--calibrate``; uniform random images (seed 0)."""
    from yolort_tpu_torch.models.yolo import build_yolo, resolve_device
    from yolort_tpu_torch.models.yolov5 import YOLOv5
    from yolort_tpu_torch.utils.profiling import calibrate_candidate_density, shift_head_bias

    device = resolve_device(args.device)
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    mkw = dict(pre_nms_topk=args.topk, row_gather=args.row_gather)
    if args.score is not None:
        mkw["score_thresh"] = args.score
    model = build_yolo(args.arch, device=device, dtype=dtype, seed=0, **mkw)
    s = args.size
    if args.calibrate:
        raw = np.random.default_rng(1).integers(0, 255, (args.batch, s, s, 3), dtype=np.uint8)
        delta = calibrate_candidate_density(YOLOv5(model=model, size=(s, s), dtype=dtype),
                                            [list(raw)])
        shift_head_bias(model, delta)
        print(f"calibrated: obj/cls bias shift {delta:.3f}", flush=True)
    x = np.random.default_rng(0).random((args.batch, s, s, 3), dtype=np.float32)
    return model, torch.from_numpy(x).to(device=device, dtype=dtype)


def cli_main(argv=None) -> List[Dict]:
    """Run the profiler; returns the rows (dicts with ``label``, ``ms``,
    ``min_ms``, ``launches``; the last prefix's also ``bit_equal``)."""
    args = parse_args(argv)
    stages = args.stages.split(",")
    unknown = sorted(set(stages) - set(STAGES))
    if unknown:
        raise SystemExit(f"unknown stages {unknown}; choose from {STAGES}")
    model, x = build(args)
    device = x.device
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host clock)"
    print(f"device={name} arch={args.arch} batch={args.batch} size={args.size} "
          f"dtype={args.dtype} topk={model.pre_nms_topk} score={model.score_thresh} "
          f"row_gather={model.row_gather}", flush=True)
    rows = []
    with torch.inference_mode():
        if "head" in stages:
            rows.append(timed(lambda: model.head_outputs(x), "backbone+pan+head", device))
        if "decode" in stages:
            rows.append(timed(lambda: model.decode(x), "+decode", device))
        pred = model.decode(x) if {"topk", "postprocess"} & set(stages) else None
        if "topk" in stages:
            def topk_only():
                scores = pred[..., 5:] * pred[..., 4:5]
                return torch.topk(scores.reshape(scores.shape[0], -1), args.topk)
            rows.append(timed(topk_only, f"decode-out topk(k={args.topk})", device))
        if "postprocess" in stages:
            rows.append(timed(lambda: model.postprocess_decoded(pred), "postprocess", device))
        if "cells" in stages:
            heads = model.head_outputs(x)
            prefixes = cell_prefixes(model, heads)
            for label, fn in prefixes:
                rows.append(timed(fn, label, device))
            got, want = prefixes[-1][1](), model.postprocess(heads)
            rows[-1]["bit_equal"] = all(torch.equal(a, b) for a, b in zip(got, want))
            print(f"{'':45s} detections bit-equal to batched_postprocess_from_heads: "
                  f"{rows[-1]['bit_equal']}", flush=True)
        if "full" in stages:
            rows.append(timed(lambda: model(x), "full pipeline", device))
            rows[-1]["images_per_s"] = args.batch / (rows[-1]["ms"] / 1e3)
            print(f"imgs/sec: {rows[-1]['images_per_s']:.1f}", flush=True)
    return rows


if __name__ == "__main__":
    cli_main()
