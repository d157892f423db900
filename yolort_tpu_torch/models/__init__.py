"""Model zoo factories: n/s/m/l/x in r6.0 (r3.1 and r4.0 through
``upstream_version`` for s/m/l), the P6 sizes n6..x6 (stride-64 letterbox
rounding), the TAN variant ts and the MobileNetV3 yolo_lite
(``yolov5_mobilenet_v3_small_fpn``, a ``YOLOLite`` for ``YOLOv5(model=...)``).
Each builds on the card unless the caller passes ``device="cpu"``; with
``pretrained=True`` it loads the arch's COCO weights from the local weights
directory (``$YOLORT_TPU_WEIGHTS``, then ``~/.cache/yolort_tpu``), which the
JAX package reads too."""

from typing import Any

from yolort_tpu_torch.models.yolo import ARCHS, YOLO, Detector, build_yolo  # noqa: F401
from yolort_tpu_torch.models.yolo_lite import YOLOLite, yolov5_mobilenet_v3_small_fpn  # noqa: F401
from yolort_tpu_torch.models.yolov5 import YOLOv5  # noqa: F401


def _factory(arch: str, size_divisible: int = 32):
    def fn(*, upstream_version: str = "r6.0", pretrained: bool = False, progress: bool = True,
           device="cuda", num_classes: int = 80, **kwargs: Any) -> YOLOv5:
        resolved = arch.replace("_r60", f"_{upstream_version.replace('.', '')}")
        if resolved not in ARCHS:
            raise NotImplementedError(f"{resolved} is not available")
        return YOLOv5(arch=resolved, pretrained=pretrained, progress=progress, device=device,
                      num_classes=num_classes, size_divisible=size_divisible, **kwargs)

    fn.__name__ = arch
    return fn


yolov5n = _factory("yolov5_darknet_pan_n_r60")
yolov5s = _factory("yolov5_darknet_pan_s_r60")
yolov5m = _factory("yolov5_darknet_pan_m_r60")
yolov5l = _factory("yolov5_darknet_pan_l_r60")
yolov5x = _factory("yolov5_darknet_pan_x_r60")
# P6 models run @1280 with stride-64 letterbox rounding
yolov5n6 = _factory("yolov5_darknet_pan_n6_r60", size_divisible=64)
yolov5s6 = _factory("yolov5_darknet_pan_s6_r60", size_divisible=64)
yolov5m6 = _factory("yolov5_darknet_pan_m6_r60", size_divisible=64)
yolov5l6 = _factory("yolov5_darknet_pan_l6_r60", size_divisible=64)
yolov5x6 = _factory("yolov5_darknet_pan_x6_r60", size_divisible=64)


def yolov5ts(*, upstream_version: str = "r4.0", pretrained: bool = False, progress: bool = True,
             device="cuda", num_classes: int = 80, **kwargs: Any) -> YOLOv5:
    """The transformer-attention small variant (r4.0 only)."""
    if upstream_version != "r4.0":
        raise NotImplementedError("TAN only supports r4.0")
    return YOLOv5(arch="yolov5_darknet_tan_s_r40", pretrained=pretrained, progress=progress,
                  device=device, num_classes=num_classes, **kwargs)


__all__ = ["Detector", "YOLO", "YOLOLite", "YOLOv5", "build_yolo", "yolov5n", "yolov5s", "yolov5m",
           "yolov5l", "yolov5x", "yolov5n6", "yolov5s6", "yolov5m6", "yolov5l6", "yolov5x6",
           "yolov5ts", "yolov5_mobilenet_v3_small_fpn"]
