"""Export an end-to-end serving artifact of a checkpoint.

    python -m yolort_tpu_torch.tools.export_model --checkpoint_path yolov5s.pt \\
        [--output_path yolov5s.ytpt] [--format exported|aoti] [--device cuda|cpu] ...

Port of ``tools/export_model.py`` (CLI parity with the reference's
tools/export_model.py:17-197): an ultralytics ``.pt`` goes through
``models/_checkpoint.load_from_ultralytics``, an ``.npz`` through
``load_params`` with ``--arch``.  ``--format exported`` writes the
``runtime.aot.export_aot`` artifact (reloaded by ``load_aot``), ``aoti`` an
AOTInductor package for ``deployment/libtorch``.  The model is built on
``--device`` (the card by default) and the artifact serves there.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def parse_args(argv=None):
    ap = argparse.ArgumentParser("yolort_tpu_torch model export")
    ap.add_argument("--checkpoint_path", required=True, help="ultralytics .pt or yolort_tpu .npz")
    ap.add_argument("--output_path", default=None,
                    help="output artifact path (default: the checkpoint's, .ytpt or .pt2)")
    ap.add_argument("--arch", default=None, help="arch name (required for .npz checkpoints)")
    ap.add_argument("--version", default="r6.0")
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--image_size", type=int, nargs=2, default=[640, 640])
    ap.add_argument("--score_thresh", type=float, default=0.25)
    ap.add_argument("--nms_thresh", type=float, default=0.45)
    ap.add_argument("--detections_per_img", type=int, default=300)
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--device", default="cuda", help="where the artifact serves (default: cuda)")
    ap.add_argument("--format", default="exported", choices=["exported", "aoti"])
    return ap.parse_args(argv)


def build_model(args):
    """The float model of the checkpoint on ``args.device`` in ``args.dtype``."""
    import torch

    from yolort_tpu_torch.models._bridge import params_from_jax
    from yolort_tpu_torch.models._checkpoint import load_from_ultralytics, load_params
    from yolort_tpu_torch.models.yolo import YOLO, build_yolo

    dtype = getattr(torch, args.dtype)
    thresholds = dict(score_thresh=args.score_thresh, nms_thresh=args.nms_thresh,
                      detections_per_img=args.detections_per_img)
    ckpt = Path(args.checkpoint_path)
    if ckpt.suffix == ".pt":
        info = load_from_ultralytics(str(ckpt), version=args.version)
        model = YOLO(info["depth_multiple"], info["width_multiple"], device=args.device,
                     dtype=dtype, version=args.version, num_classes=info["num_classes"],
                     use_p6=info["use_p6"], strides=info["strides"],
                     anchor_grids=info["anchor_grids"], **thresholds)
        params = info["params"]
    else:
        if not args.arch:
            raise SystemExit("--arch is required for .npz checkpoints")
        params, meta = load_params(str(ckpt))
        model = build_yolo(args.arch, device=args.device, dtype=dtype,
                           num_classes=meta.get("num_classes", 80), **thresholds)
    params_from_jax(params, model)
    return model


def cli_main(argv=None) -> str:
    args = parse_args(argv)
    import torch

    from yolort_tpu_torch.runtime.aot import export_aot, export_aoti_package

    model = build_model(args)
    ckpt = Path(args.checkpoint_path)
    dtype = getattr(torch, args.dtype)
    shape = dict(batch_size=args.batch_size, input_hw=tuple(args.image_size), dtype=dtype)
    if args.format == "aoti":
        out = args.output_path or str(ckpt.with_suffix(".pt2"))
        export_aoti_package(model, out, **shape)
    else:
        out = args.output_path or str(ckpt.with_suffix(".ytpt"))
        export_aot(model, out, meta={"checkpoint": str(ckpt), "score_thresh": args.score_thresh},
                   **shape)
    print(f"exported: {out}")
    return out


if __name__ == "__main__":
    cli_main()
