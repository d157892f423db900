"""COCO mAP evaluation of a checkpoint.

    python -m yolort_tpu_torch.tools.eval_metric --checkpoint_path FILE.pt|FILE.npz
        [--arch NAME] --image_path DIR --annotation_path FILE.json
        [--batch_size 16] [--image_size 640] [--device cpu]
        [--num_chips N --rank R --init_method tcp://localhost:PORT]

Port of ``tools/eval_metric.py``: an ultralytics ``.pt`` or a ``.npz`` of
``save_params`` (``--arch`` names its architecture), evaluated by
``trainer.fit.evaluate`` with the annotations' ``iscrowd`` and ``area``
(the boxes scaled back to each image with ``scale_coords_back``, the
results of ``data.coco_eval.COCOEvaluator``).  ``--num_chips`` is the
data-axis size: with more than one, each of the ``--num_chips`` processes
is started with its ``--rank`` and the same ``--init_method``, the model is
loaded onto its rank's device, and the batches are served by
``data_parallel_infer`` (the multi-device inference the reference refuses,
its tools/eval_metric.py:109), a partial batch padded up to a multiple of
the data axis.  A process group of more than one rank that is already up
is used as it is.  ``--device`` is a torch device, the card by default (no
fallback to the CPU).
"""

from __future__ import annotations

import argparse
from typing import Dict


def parse_args(argv=None):
    ap = argparse.ArgumentParser("yolort_tpu_torch COCO evaluation")
    ap.add_argument("--checkpoint_path", required=True, help="ultralytics .pt or .npz")
    ap.add_argument("--arch", default=None, help="arch name (required for .npz)")
    ap.add_argument("--num_classes", type=int, default=None)
    ap.add_argument("--version", default="r6.0")
    ap.add_argument("--image_path", required=True, help="COCO image dir")
    ap.add_argument("--annotation_path", required=True, help="instances json")
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--image_size", type=int, default=640)
    ap.add_argument("--score_thresh", type=float, default=0.005)
    ap.add_argument("--nms_thresh", type=float, default=0.45)
    ap.add_argument("--num_chips", type=int, default=1, help="data-axis size (processes)")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--init_method", default=None, help="rendezvous of the processes")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def load_model(args, device: str):
    """The ``Detector`` of ``args.checkpoint_path`` on ``device``."""
    if args.checkpoint_path.endswith(".npz"):
        from yolort_tpu_torch.models._bridge import params_from_jax
        from yolort_tpu_torch.models._checkpoint import load_params
        from yolort_tpu_torch.models.yolo import build_yolo

        params, meta = load_params(args.checkpoint_path)
        if not args.arch:
            raise SystemExit("--arch is required for .npz checkpoints")
        model = build_yolo(args.arch, device=device,
                           num_classes=int(meta.get("num_classes", args.num_classes or 80)),
                           score_thresh=args.score_thresh, nms_thresh=args.nms_thresh)
        return params_from_jax(params, model)
    from yolort_tpu_torch.models.yolov5 import YOLOv5

    return YOLOv5.load_from_yolov5(args.checkpoint_path, version=args.version,
                                   score_thresh=args.score_thresh, nms_thresh=args.nms_thresh,
                                   device=device).model


def _mesh(args):
    """The data-parallel mesh of this process, or None for one device."""
    import torch.distributed as dist

    from yolort_tpu_torch.parallel import make_mesh

    if dist.is_initialized() and dist.get_world_size() > 1:
        devices = None if args.device.startswith("cuda") else [args.device] * dist.get_world_size()
        return make_mesh(devices)
    if args.num_chips <= 1:
        return None
    if args.init_method is None:
        raise SystemExit("--num_chips > 1 needs --init_method (and each process its --rank)")
    devices = None if args.device.startswith("cuda") else [args.device] * args.num_chips
    return make_mesh(devices, init_method=args.init_method, world_size=args.num_chips,
                     rank=args.rank)


def cli_main(argv=None) -> Dict[str, float]:
    args = parse_args(argv)
    from yolort_tpu_torch.data.coco import COCODetection
    from yolort_tpu_torch.data.data_module import DetectionDataModule
    from yolort_tpu_torch.parallel.distributed import is_main_process
    from yolort_tpu_torch.trainer.fit import evaluate

    mesh = _mesh(args)  # first: each rank loads the model onto its own device
    model = load_model(args, args.device if mesh is None else str(mesh.device))
    ds = COCODetection(args.image_path, args.annotation_path)
    s = args.image_size
    dm = DetectionDataModule(ds, batch_size=args.batch_size, canvas_hw=(s, s), min_size=s,
                             max_size=s)
    results = evaluate(model, dm, (s, s), mesh=mesh,
                       target_keys=("boxes", "labels", "iscrowd", "area"))
    if is_main_process():
        for k, v in results.items():
            print(f"{k}: {v:.4f}")
    return results


if __name__ == "__main__":
    cli_main()
