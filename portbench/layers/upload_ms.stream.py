"""Device ms a batch of host-to-device copies: the frames ``__call__``
uploads (models/yolov5.py), in one copy from the pinned host buffer of
its staging arena (utils/staging.py).

Moves ``frames_per_s``."""

from portbench.layers._device import upload_ms


def read(run):
    return upload_ms(run)
