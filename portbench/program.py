"""The system under test: ``yolort_tpu_torch``'s ``YOLOv5``, built the way a
user builds it from an ultralytics checkpoint, and the spans the
benchmark records around its layers in a traced run.

This is the one module of the benchmark that imports the program.
"""

from __future__ import annotations

import functools

import torch

SPAN_PREFIX = "portbench."
# (span, wraps the network's method rather than YOLOv5's, method): each
# wrapped on the instance, not the class
SPANS = (("letterbox", False, "canvas"), ("letterbox", False, "canvas_mixed"),
         ("network", True, "head_outputs"), ("postprocess", True, "postprocess"))
REQUEST_SPAN = SPAN_PREFIX + "request"


def dtype_of(config: dict) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[config["dtype"]]


def build(checkpoint: str, config: dict, traffic: dict, device):
    """``YOLOv5.load_from_yolov5`` with the configuration's dtype, canvas
    and stage-2 route and the mix's thresholds and ``fixed_shape``."""
    from yolort_tpu_torch.models.yolov5 import YOLOv5

    post = traffic["post"]
    fixed = traffic.get("fixed_shape")
    return YOLOv5.load_from_yolov5(
        checkpoint, version=config["version"], device=device, dtype=dtype_of(config),
        size=tuple(config["size"]), size_divisible=int(config["size_divisible"]),
        fixed_shape=None if fixed is None else tuple(fixed),
        score_thresh=post["score_thresh"], nms_thresh=post["nms_thresh"],
        pre_nms_topk=post["pre_nms_topk"], detections_per_img=post["detections_per_img"],
        row_gather=config["row_gather"])


def int8_control(m, calibration_requests) -> None:
    """Switch the program's own int8 path on (the port's post-training
    quantization recipe, calibrated on the cell's frames), in place."""
    import numpy as np

    from yolort_tpu_torch.ops.quantization import (
        calibrate_activations, finalize_scales, quantize_compute_params,
    )

    canvases = []
    for frames in calibration_requests:
        x = torch.from_numpy(np.stack(frames)).to(m.device)
        with torch.no_grad():
            canvases.append(m.canvas(x)[0].contiguous())
    with torch.no_grad():
        calibrate_activations(m.model, canvases)
        qmodel = quantize_compute_params(m.model)
        finalize_scales(qmodel, canvases[0])
    m.model = qmodel


def install_spans(m) -> None:
    """Wrap the layer entries of ``m`` and of its network in
    ``record_function`` spans named ``portbench.<layer>``."""
    from torch.profiler import record_function

    def wrap(obj, attr, span):
        fn = getattr(obj, attr)

        @functools.wraps(fn)
        def inner(*a, **kw):
            with record_function(span):
                return fn(*a, **kw)
        setattr(obj, attr, inner)

    for layer, on_network, attr in SPANS:
        wrap(m.model if on_network else m, attr, SPAN_PREFIX + layer)


def forbidden_modules(names, forbidden=("jax", "jaxlib", "flax", "yolort_tpu")):
    """Loaded modules whose top-level name (the part before the first dot)
    is one of ``forbidden``, compared whole."""
    return sorted(n for n in names if n.split(".", 1)[0] in forbidden)
