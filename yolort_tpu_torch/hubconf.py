"""torch.hub entry points of the port: the 11 factories of
``yolort_tpu_torch.models``, each building a ``YOLOv5`` on the card unless
``device="cpu"`` is passed.

    import torch
    model = torch.hub.load("<checkout>/yolort_tpu_torch", "yolov5s", source="local",
                           device="cuda", score_thresh=0.25)

Every keyword goes to the factory (``upstream_version``, ``size``,
``fixed_shape``, ``dtype``, ``classes_per_anchor``, ...).  ``pretrained=True``
loads the arch's COCO weights from the local weights directory
(``$YOLORT_TPU_WEIGHTS``, then ``~/.cache/yolort_tpu``; a hub mirror only
where ``YOLORT_HUB_BASE`` names one), as the factory does.
"""

import os
import sys

# torch.hub puts this directory on sys.path; the package is its parent's
_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _CHECKOUT not in sys.path:
    sys.path.insert(0, _CHECKOUT)

from yolort_tpu_torch import models as _models  # noqa: E402

dependencies = ["torch", "numpy"]


def _entry(name: str):
    factory = getattr(_models, name)

    def entry(pretrained: bool = False, **kwargs):
        return factory(pretrained=pretrained, **kwargs)

    entry.__name__ = entry.__qualname__ = name
    entry.__doc__ = f"``yolort_tpu_torch.models.{name}``."
    return entry


yolov5n = _entry("yolov5n")
yolov5s = _entry("yolov5s")
yolov5m = _entry("yolov5m")
yolov5l = _entry("yolov5l")
yolov5x = _entry("yolov5x")
yolov5n6 = _entry("yolov5n6")
yolov5s6 = _entry("yolov5s6")
yolov5m6 = _entry("yolov5m6")
yolov5l6 = _entry("yolov5l6")
yolov5x6 = _entry("yolov5x6")
yolov5ts = _entry("yolov5ts")
