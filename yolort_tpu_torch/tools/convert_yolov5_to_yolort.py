"""Convert an ultralytics/yolov5 checkpoint to the ``.npz`` both packages read.

    python -m yolort_tpu_torch.tools.convert_yolov5_to_yolort --checkpoint_path FILE.pt
        [--output_path DIR] [--version r6.0]

Port of ``tools/convert_yolov5_to_yolort.py`` on
``models._checkpoint.convert_yolov5_checkpoint`` (torch and numpy only).
"""

from __future__ import annotations

import argparse


def cli_main(argv=None) -> str:
    ap = argparse.ArgumentParser("ultralytics -> yolort_tpu checkpoint converter")
    ap.add_argument("--checkpoint_path", required=True)
    ap.add_argument("--output_path", default=".")
    ap.add_argument("--version", default="r6.0", choices=["r3.1", "r4.0", "r6.0"])
    args = ap.parse_args(argv)

    from yolort_tpu_torch.models._checkpoint import convert_yolov5_checkpoint

    out = convert_yolov5_checkpoint(args.checkpoint_path, args.output_path, version=args.version)
    print(f"converted: {out}")
    return out


if __name__ == "__main__":
    cli_main()
