"""Train a YOLOv5 model on a COCO-format dataset.

    python -m yolort_tpu_torch.tools.train --num_classes N \
        --image_path DIR --annotation_path FILE [--device cpu] ...

Port of ``tools/train.py``: the same flags but ``--data_parallel``, and the
model runs on ``--device`` (the card by default; no fallback to the CPU).
The trained (EMA) params are written to ``--output_path`` after every
epoch, in the npz form both packages' ``load_params`` read.
"""

from __future__ import annotations

import argparse


def cli_main(argv=None) -> None:
    ap = argparse.ArgumentParser("yolort_tpu_torch training")
    ap.add_argument("--arch", default="yolov5_darknet_pan_s_r60")
    ap.add_argument("--num_classes", type=int, required=True)
    ap.add_argument("--image_path", required=True)
    ap.add_argument("--annotation_path", required=True)
    ap.add_argument("--val_image_path", default=None)
    ap.add_argument("--val_annotation_path", default=None)
    ap.add_argument("--batch_size", type=int, default=16)
    ap.add_argument("--image_size", type=int, default=640)
    ap.add_argument("--max_epochs", type=int, default=50)
    ap.add_argument("--lr", type=float, default=0.01)
    ap.add_argument("--hyp", default=None,
                    help="hyperparameter yaml (hyp.scratch.yaml schema); "
                         "drives loss gains, optimizer, and augmentations")
    ap.add_argument("--patience", type=int, default=None)
    ap.add_argument("--output_path", default="trained.npz")
    ap.add_argument("--resume", default=None, help="train-state npz to resume from")
    ap.add_argument("--no_ema", action="store_true")
    ap.add_argument("--augment", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from yolort_tpu_torch.data.coco import COCODetection
    from yolort_tpu_torch.data.data_module import DetectionDataModule
    from yolort_tpu_torch.data.transforms import default_train_transforms
    from yolort_tpu_torch.models.yolo import build_yolo
    from yolort_tpu_torch.trainer.checkpoint import load_train_state
    from yolort_tpu_torch.trainer.fit import fit
    from yolort_tpu_torch.trainer.hyp import load_hyp
    from yolort_tpu_torch.trainer.task import DefaultTask

    hyp = load_hyp(args.hyp) if args.hyp else None

    s = args.image_size
    transforms = default_train_transforms(args.seed, hyp=hyp) if args.augment else None
    train_ds = COCODetection(args.image_path, args.annotation_path, transforms=transforms)
    train_dm = DetectionDataModule(
        train_ds, batch_size=args.batch_size, canvas_hw=(s, s), min_size=s, max_size=s,
        shuffle=True, seed=args.seed,
    )
    val_dm = None
    if args.val_annotation_path:
        val_ds = COCODetection(args.val_image_path or args.image_path, args.val_annotation_path)
        val_dm = DetectionDataModule(
            val_ds, batch_size=args.batch_size, canvas_hw=(s, s), min_size=s, max_size=s
        )

    model = build_yolo(args.arch, num_classes=args.num_classes, device=args.device)
    task = DefaultTask(model, lr=args.lr, hyp=hyp)
    state = None
    if args.resume:
        state, meta = load_train_state(args.resume, task)
        print(f"resumed from {args.resume} (step {state.step}, meta {meta})")

    fit(
        task,
        train_dm,
        val_data=val_dm,
        max_epochs=args.max_epochs,
        seed=args.seed,
        use_ema=not args.no_ema,
        patience=args.patience,
        checkpoint_path=args.output_path,
        state=state,
    )
    print(f"saved: {args.output_path}")


if __name__ == "__main__":
    cli_main()
