"""Run detection over images and videos and save the rendered results.

    python -m yolort_tpu_torch.tools.detect --source PATH [--checkpoint_path FILE.pt]
        [--arch NAME] [--score_thresh T] [--nms_thresh T] [--save_dir DIR] [--crop]
        [--device cpu]

Port of ``tools/detect.py`` on ``YOLOv5``, ``data.datasets.LoadImages`` and
``utils.results.DetectionResults``.  ``--device`` is a torch device, the
card by default (no fallback to the CPU).
"""

from __future__ import annotations

import argparse
from pathlib import Path


def cli_main(argv=None):
    ap = argparse.ArgumentParser("yolort_tpu_torch detect")
    ap.add_argument("--source", required=True, help="image/video file, dir, or glob")
    ap.add_argument("--checkpoint_path", default=None, help="ultralytics .pt (optional)")
    ap.add_argument("--arch", default="yolov5_darknet_pan_s_r60")
    ap.add_argument("--score_thresh", type=float, default=0.25)
    ap.add_argument("--nms_thresh", type=float, default=0.45)
    ap.add_argument("--save_dir", default="runs/detect")
    ap.add_argument("--crop", action="store_true", help="also save per-detection crops")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from yolort_tpu_torch.data.datasets import LoadImages
    from yolort_tpu_torch.models.yolov5 import YOLOv5
    from yolort_tpu_torch.utils.results import DetectionResults

    if args.checkpoint_path:
        model = YOLOv5.load_from_yolov5(args.checkpoint_path, score_thresh=args.score_thresh,
                                        nms_thresh=args.nms_thresh, device=args.device)
    else:
        model = YOLOv5(arch=args.arch, score_thresh=args.score_thresh,
                       nms_thresh=args.nms_thresh, device=args.device)

    files, images = [], []
    for f, img in LoadImages(args.source):
        files.append(f)
        images.append(img)
    preds = model(images)
    results = DetectionResults(images, preds, files=files)
    results.print()
    saved = results.save(args.save_dir)
    print(f"saved {len(saved)} rendered images to {args.save_dir}")
    if args.crop:
        results.crop(save_dir=str(Path(args.save_dir) / "crops"))
    return results


if __name__ == "__main__":
    cli_main()
