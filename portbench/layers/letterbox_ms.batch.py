"""Device ms a batch of the kernels launched inside ``YOLOv5.canvas`` /
``canvas_mixed`` (models/transform.py): uint8 to float, resize, canvas.

Moves ``images_per_s``."""

from portbench.layers._device import per_batch_ms


def read(run):
    return per_batch_ms(run, "portbench.letterbox")
