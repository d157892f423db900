"""yolort_tpu_torch: the YOLOv5 runtime of ``yolort_tpu`` in PyTorch, with
hand-written CUDA kernels for an NVIDIA H100 (Hopper, sm_90a).

Imports torch and numpy only.  The kernels are built with ``nvcc`` at
their first launch (``ops/cuda/_build.py``); on CPU tensors every kernel
wrapper takes its plain PyTorch version.
"""

from yolort_tpu_torch.models import (  # noqa: F401
    YOLO,
    YOLOv5,
    yolov5l,
    yolov5l6,
    yolov5m,
    yolov5m6,
    yolov5n,
    yolov5n6,
    yolov5s,
    yolov5s6,
    yolov5_mobilenet_v3_small_fpn,
    yolov5ts,
    yolov5x,
    yolov5x6,
)

__all__ = ["YOLO", "YOLOv5", "yolov5n", "yolov5s", "yolov5m", "yolov5l", "yolov5x", "yolov5n6",
           "yolov5s6", "yolov5m6", "yolov5l6", "yolov5x6", "yolov5ts",
           "yolov5_mobilenet_v3_small_fpn"]
