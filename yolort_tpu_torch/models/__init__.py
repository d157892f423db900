"""Model zoo factories for the r6.0 sizes n/s/m/l/x.  Each builds on the
card unless the caller passes ``device="cpu"``."""

from typing import Any

from yolort_tpu_torch.models.yolo import ARCHS, YOLO, build_yolo  # noqa: F401
from yolort_tpu_torch.models.yolov5 import YOLOv5  # noqa: F401


def _factory(arch: str):
    def fn(*, device="cuda", num_classes: int = 80, **kwargs: Any) -> YOLOv5:
        return YOLOv5(arch=arch, device=device, num_classes=num_classes, **kwargs)

    fn.__name__ = arch
    return fn


yolov5n = _factory("yolov5_darknet_pan_n_r60")
yolov5s = _factory("yolov5_darknet_pan_s_r60")
yolov5m = _factory("yolov5_darknet_pan_m_r60")
yolov5l = _factory("yolov5_darknet_pan_l_r60")
yolov5x = _factory("yolov5_darknet_pan_x_r60")

__all__ = ["YOLO", "YOLOv5", "build_yolo", "yolov5n", "yolov5s", "yolov5m", "yolov5l", "yolov5x"]
