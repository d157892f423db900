"""Training hyperparameter dictionaries (the reference's hyp yaml system).

Copy of ``yolort_tpu/trainer/hyp.py``: ``DEFAULT_HYP`` holds the values of
the reference's hyp.scratch.yaml, which drive the loss gains, the optimizer
and the augmentations; ``load_hyp`` overlays a user yaml on them, so partial
files work (``yaml`` is imported only then).
"""

from __future__ import annotations

from typing import Dict, Optional

# Values from the reference hyp.scratch.yaml (COCO-from-scratch defaults).
DEFAULT_HYP: Dict[str, float] = {
    "lr0": 0.01,            # initial learning rate
    "lrf": 0.2,             # final one-cycle LR fraction (lr0 * lrf)
    "momentum": 0.937,
    "weight_decay": 0.0005,
    "warmup_epochs": 3.0,
    "warmup_momentum": 0.8,
    "warmup_bias_lr": 0.1,
    "box": 0.05,            # box loss gain
    "cls": 0.5,             # cls loss gain
    "cls_pw": 1.0,          # cls BCE positive weight
    "obj": 1.0,             # obj loss gain
    "obj_pw": 1.0,          # obj BCE positive weight
    "iou_t": 0.20,
    "anchor_t": 4.0,        # anchor-multiple threshold
    "fl_gamma": 0.0,        # focal loss gamma (0 disables)
    "label_smoothing": 0.0,
    "hsv_h": 0.015,
    "hsv_s": 0.7,
    "hsv_v": 0.4,
    "degrees": 0.0,
    "translate": 0.1,
    "scale": 0.5,
    "shear": 0.0,
    "perspective": 0.0,
    "flipud": 0.0,
    "fliplr": 0.5,
    "mosaic": 1.0,
    "mixup": 0.0,
    "copy_paste": 0.0,
    "cutout": 0.0,
}


def load_hyp(path: Optional[str] = None) -> Dict[str, float]:
    """Defaults overlaid with a user yaml (unknown keys pass through so
    custom hyps reach user code, matching the reference's free-form dict)."""
    hyp = dict(DEFAULT_HYP)
    if path:
        import yaml

        with open(path) as f:
            user = yaml.safe_load(f) or {}
        if not isinstance(user, dict):
            raise ValueError(f"hyp file {path} must contain a mapping")
        hyp.update({k: v for k, v in user.items()})
    return hyp
