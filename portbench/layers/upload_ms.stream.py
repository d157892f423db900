"""Device ms a batch of host-to-device copies: the frames ``__call__``
uploads (models/yolov5.py), pageable memory.

Moves ``frames_per_s``."""

from portbench.layers._device import upload_ms


def read(run):
    return upload_ms(run)
