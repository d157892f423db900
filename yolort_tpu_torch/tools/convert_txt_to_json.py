"""YOLO-txt annotations -> a COCO json.

    python -m yolort_tpu_torch.tools.convert_txt_to_json --image_root DIR
        --label_root DIR --class_names a,b,c|FILE --output_path FILE.json

Port of ``tools/convert_txt_to_json.py`` on
``utils.annotations_converter.AnnotationsConverter``.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def cli_main(argv=None) -> dict:
    ap = argparse.ArgumentParser("YOLO txt -> COCO json converter")
    ap.add_argument("--image_root", required=True)
    ap.add_argument("--label_root", required=True)
    ap.add_argument("--class_names", required=True,
                    help="comma-separated or a file with one name per line")
    ap.add_argument("--output_path", required=True)
    args = ap.parse_args(argv)

    from yolort_tpu_torch.utils.annotations_converter import AnnotationsConverter

    p = Path(args.class_names)
    names = ([line.strip() for line in p.read_text().splitlines() if line.strip()]
             if p.exists() else args.class_names.split(","))
    coco = AnnotationsConverter(args.image_root, args.label_root, names).generate(
        args.output_path)
    print(f"written: {args.output_path}")
    return coco


if __name__ == "__main__":
    cli_main()
