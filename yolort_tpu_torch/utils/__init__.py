"""Host-side helpers of the port: detection results, image drawing,
magnitude pruning, box conversions, detection metrics, the YOLO-txt to
COCO converter, the dtype cast of a model, optional-dependency checks,
robustness (timeouts, retries, the checkpoint downloader), profiling and
feature taps, anchors, plots and the visualizer.  numpy (and torch) only;
OpenCV is imported where an image is read, drawn or written."""

from yolort_tpu_torch.utils.common import cast_floating, count_params  # noqa: F401
from yolort_tpu_torch.utils.dependency import (  # noqa: F401
    check_version,
    is_module_available,
    requires_module,
)

__all__ = ["cast_floating", "count_params", "check_version", "is_module_available",
           "requires_module"]
