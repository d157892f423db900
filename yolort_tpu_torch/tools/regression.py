"""Real-weights regression: ingestion bit-parity and the COCO mAP floors,
on the card unless the caller passes ``--device cpu``.

    python -m yolort_tpu_torch.tools.regression --weights yolov5s.pt --data coco128/
        [--image_size 640] [--batch_size 16] [--score_thresh 0.001]
        [--ap_floor 42.5] [--ap50_floor 65.3] [--device cuda]
    python -m yolort_tpu_torch.tools.regression --selftest [--selftest-dir DIR]

Port of ``tools/regression.py``:

  1. **Ingestion bit-parity** (``check_bit_parity``): the checkpoint loaded
     through both ingestion routes, the index-map converter
     (``models._checkpoint.load_from_ultralytics`` into ``YOLO``) and the
     generic yaml one (``models.yaml_model.load_yaml_from_ultralytics``),
     must give decoded predictions equal at rtol=0, atol=0.
  2. **mAP floor** (``run_map_floor``): COCO-protocol evaluation of
     ``YOLOv5.load_from_yolov5(fixed_shape=...)`` over the dataset
     (``data.coco.COCODetection``, ``data.data_module.DetectionDataModule``,
     ``data.coco_eval.COCOEvaluator``); AP > ``--ap_floor`` and AP50 >
     ``--ap50_floor``.  A data directory with YOLO-txt labels and no COCO
     json has its annotations converted first
     (``utils.annotations_converter``).

``--selftest`` runs the whole harness without real files
(``run_selftest``): a fabricated 80-class checkpoint
(``tests/torch_fixture.make_checkpoint``, loaded by path from the
checkout) and 8 synthetic images whose labels are the model's own
interior detections.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch


def find_coco128_layout(root: Path):
    """(image dir, annotation json) of a coco128-shaped directory; the json
    is written from the YOLO-txt labels where there is none."""
    img_candidates = [root / "images" / "train2017", root / "images", root]
    img_dir = next((d for d in img_candidates if d.is_dir() and any(d.glob("*.jpg"))), None)
    if img_dir is None:
        raise FileNotFoundError(f"no images under {root}")
    for cand in (root / "annotations" / "instances_train2017.json",
                 root / "annotations.json", root / "instances.json"):
        if cand.exists():
            return img_dir, cand
    label_dir = root / "labels" / "train2017"
    if label_dir.is_dir():
        from yolort_tpu_torch.data.builtin_meta import COCO_CLASSES
        from yolort_tpu_torch.utils.annotations_converter import AnnotationsConverter

        out = root / "annotations"
        out.mkdir(exist_ok=True)
        ann_path = out / "instances_train2017.json"
        AnnotationsConverter(str(img_dir), str(label_dir), COCO_CLASSES).generate(str(ann_path))
        return img_dir, ann_path
    raise FileNotFoundError(f"no COCO json or yolo labels under {root}")


def check_bit_parity(weights: str, img_size: int = 320, device="cuda") -> Dict:
    """Decoded predictions of one random image (seed 0) through both
    ingestion routes, on ``device`` in float32: equal at rtol=0, atol=0
    (raises otherwise).  A checkpoint without its yaml rows is skipped."""
    from yolort_tpu_torch.models._bridge import params_from_jax
    from yolort_tpu_torch.models._checkpoint import load_from_ultralytics
    from yolort_tpu_torch.models.yaml_model import load_yaml_from_ultralytics
    from yolort_tpu_torch.models.yolo import YOLO, resolve_device

    device = resolve_device(device)
    info = load_from_ultralytics(weights)
    fixed = YOLO(info["depth_multiple"], info["width_multiple"], device=device,
                 num_classes=info["num_classes"], use_p6=info["use_p6"],
                 strides=tuple(info["strides"]),
                 anchor_grids=tuple(tuple(a) for a in info["anchor_grids"]))
    params_from_jax(info["params"], fixed)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, 1, (1, img_size, img_size, 3)).astype(np.float32))
    x = x.to(device)
    with torch.inference_mode():
        pred_fixed = fixed.decode(x).cpu().numpy()
    try:
        ymodel = load_yaml_from_ultralytics(weights, device=device)
    except ValueError as e:  # a checkpoint without its full yaml rows
        return {"bit_parity": "skipped", "reason": str(e)}
    with torch.inference_mode():
        pred_yaml = ymodel.decode(x).cpu().numpy()
    np.testing.assert_allclose(pred_yaml, pred_fixed, rtol=0, atol=0)
    return {"bit_parity": "exact", "max_delta": 0.0, "num_classes": info["num_classes"],
            "size": info["size"]}


def run_map_floor(weights: str, data_root: str, img_size: int, batch_size: int,
                  score_thresh: float, collect_preds: Optional[List] = None,
                  max_dets: int = 100, device="cuda") -> Dict[str, float]:
    """COCO metrics (in percent, 2 decimals) of the checkpoint over the
    dataset at ``img_size`` on ``device``; with ``collect_preds`` each
    image's detections (original coordinates) are appended to it."""
    from yolort_tpu_torch.data.coco import COCODetection
    from yolort_tpu_torch.data.coco_eval import COCOEvaluator
    from yolort_tpu_torch.data.data_module import DetectionDataModule
    from yolort_tpu_torch.models.transform import scale_coords_back
    from yolort_tpu_torch.models.yolov5 import YOLOv5

    img_dir, ann = find_coco128_layout(Path(data_root))
    ds = COCODetection(str(img_dir), str(ann))
    dm = DetectionDataModule(ds, batch_size=batch_size, canvas_hw=(img_size, img_size),
                             min_size=img_size, max_size=img_size)
    m = YOLOv5.load_from_yolov5(weights, score_thresh=score_thresh,
                                fixed_shape=(img_size, img_size), device=device)
    ev = COCOEvaluator(max_dets=max_dets)
    n_done = 0
    for batch in dm.batches():
        with torch.inference_mode():
            det = m.model(torch.from_numpy(batch["images"]).to(m.device))
        boxes_all, scores, labels, num = (det.boxes.cpu(), det.scores.cpu().numpy(),
                                          det.labels.cpu().numpy(), det.num.cpu().numpy())
        preds, tgts = [], []
        for j, raw in enumerate(batch["raw_targets"]):
            n = int(num[j])
            oh, ow = (int(v) for v in raw["orig_size"])
            boxes = scale_coords_back(boxes_all[j, :n], (img_size, img_size),
                                      torch.tensor([oh, ow], dtype=torch.float32)).numpy()
            preds.append({"boxes": boxes, "scores": scores[j, :n], "labels": labels[j, :n]})
            tgt = {"boxes": raw["boxes"], "labels": raw["labels"],
                   "iscrowd": raw.get("iscrowd"), "area": raw.get("area")}
            tgts.append({k: v for k, v in tgt.items() if v is not None})
            if collect_preds is not None:
                collect_preds.append({"image": raw.get("file_name") or raw.get("image_id"),
                                      "orig_size": (oh, ow), **preds[-1]})
        ev.update(preds, tgts)
        n_done += len(preds)
        print(f"\r{n_done}/{len(ds)} images", end="", flush=True)
    print()
    return {k: round(v * 100, 2) for k, v in ev.compute().items()}


def _torch_fixture():
    """The checkout's ``tests/torch_fixture.py`` (torch only), loaded by path:
    an installed package named ``tests`` would shadow it."""
    import importlib.util

    path = Path(__file__).resolve().parents[2] / "tests" / "torch_fixture.py"
    if not path.exists():
        raise FileNotFoundError(f"--selftest needs the checkout's {path}")
    spec = importlib.util.spec_from_file_location("torch_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_selftest(workdir: Optional[str] = None, img_size: int = 320, n_images: int = 8,
                 device="cuda") -> Dict:
    """The whole harness on fabricated files: an 80-class checkpoint
    (``make_checkpoint(nc=80, dm=0.33, wm=0.25, seed=3,
    head_cls_bias_noise=2.0)``) and a coco128-shaped dataset of
    ``n_images`` 280x320 noise images whose YOLO-txt labels are the
    model's own interior detections (pass 1).  Pass 2 is the real path:
    the txt labels converted to json, both ingestion routes held bit-equal,
    the evaluation, and the floors AP > 25 and AP50 > 25 (the model
    re-finds each label at IoU 1; its detections outside the images, which
    cannot be labels, rank among them).  Raises where a check fails."""
    import tempfile

    import cv2

    from yolort_tpu_torch.data.builtin_meta import COCO_CLASSES
    from yolort_tpu_torch.utils.annotations_converter import AnnotationsConverter

    root = Path(workdir or tempfile.mkdtemp(prefix="yolort_selftest_"))
    root.mkdir(parents=True, exist_ok=True)
    weights = str(root / "fixture_s.pt")
    _torch_fixture().make_checkpoint(weights, nc=80, dm=0.33, wm=0.25, seed=3,
                                     head_cls_bias_noise=2.0)
    img_dir = root / "images" / "train2017"
    lbl_dir = root / "labels" / "train2017"
    img_dir.mkdir(parents=True, exist_ok=True)
    lbl_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(11)
    for i in range(n_images):
        cv2.imwrite(str(img_dir / f"selftest_{i:04d}.jpg"),
                    rng.integers(0, 255, (280, 320, 3), dtype=np.uint8))
        (lbl_dir / f"selftest_{i:04d}.txt").write_text("")

    # pass 1: the model's own detections become the labels
    collected: List[Dict] = []
    ann_path = root / "annotations" / "instances_train2017.json"
    ann_path.parent.mkdir(exist_ok=True)
    AnnotationsConverter(str(img_dir), str(lbl_dir), COCO_CLASSES).generate(str(ann_path))
    run_map_floor(weights, str(root), img_size, 4, 1e-6, collect_preds=collected, max_dets=300,
                  device=device)
    if not collected:
        raise AssertionError("selftest inference produced no predictions")
    id_to_name = {img["id"]: Path(img["file_name"]).stem
                  for img in json.loads(ann_path.read_text())["images"]}
    for rec in collected:
        oh, ow = rec["orig_size"]
        # COCODetection clamps boxes to the image and drops degenerate ones,
        # so only interior detections can be labels
        lines = []
        for bi in range(len(rec["scores"])):
            x1, y1, x2, y2 = (float(v) for v in rec["boxes"][bi])
            interior = (x1 >= 2 and y1 >= 2 and x2 <= ow - 2 and y2 <= oh - 2
                        and (x2 - x1) >= 4 and (y2 - y1) >= 4)
            if interior:
                cx, cy = (x1 + x2) / 2 / ow, (y1 + y2) / 2 / oh
                lines.append(f"{int(rec['labels'][bi])} {cx:.6f} {cy:.6f} {(x2 - x1) / ow:.6f} "
                             f"{(y2 - y1) / oh:.6f}")
        name = id_to_name[int(rec["image"])]
        (lbl_dir / f"{name}.txt").write_text("\n".join(lines) + "\n")
    ann_path.unlink()  # pass 2 converts the txt labels again

    # pass 2: the harness path a real run takes
    report: Dict = {"selftest_dir": str(root)}
    report.update(check_bit_parity(weights, device=device))
    if report["bit_parity"] != "exact":
        raise AssertionError(f"selftest bit parity: {report}")
    metrics = run_map_floor(weights, str(root), img_size, 4, 1e-6, max_dets=300, device=device)
    report["metrics"] = metrics
    if not (metrics["AP"] > 25.0 and metrics["AP50"] > 25.0):
        raise AssertionError(f"selftest mAP floor: {metrics}")
    report["map_floor"] = "pass"
    return report


def cli_main(argv=None) -> Dict:
    ap = argparse.ArgumentParser("yolort_tpu_torch real-weights regression harness")
    ap.add_argument("--selftest", action="store_true",
                    help="the harness end to end on a fabricated checkpoint and synthetic "
                         "coco128-shaped data")
    ap.add_argument("--selftest-dir", default=None)
    ap.add_argument("--weights", default=None, help="ultralytics .pt checkpoint")
    ap.add_argument("--data", default=None, help="coco128 directory (no mAP check without it)")
    ap.add_argument("--image_size", type=int, default=640)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--score_thresh", type=float, default=0.001)
    ap.add_argument("--ap_floor", type=float, default=42.5)
    ap.add_argument("--ap50_floor", type=float, default=65.3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.selftest:
        report = run_selftest(args.selftest_dir, device=args.device)
        print(json.dumps(report, default=str).replace("NaN", "null"))
        return report
    if not args.weights:
        ap.error("--weights is required (or use --selftest)")

    report = {"weights": args.weights}
    report.update(check_bit_parity(args.weights, device=args.device))
    print(f"[1/2] ingestion bit-parity: {report['bit_parity']}")
    if args.data:
        metrics = run_map_floor(args.weights, args.data, args.image_size, args.batch_size,
                                args.score_thresh, device=args.device)
        report["metrics"] = metrics
        ok = metrics["AP"] > args.ap_floor and metrics["AP50"] > args.ap50_floor
        report["map_floor"] = "pass" if ok else "FAIL"
        print(f"[2/2] mAP floor: AP={metrics['AP']} (>{args.ap_floor}) AP50={metrics['AP50']} "
              f"(>{args.ap50_floor}) -> {report['map_floor']}")
        if not ok:
            print(json.dumps(report))
            raise SystemExit(1)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    cli_main()
