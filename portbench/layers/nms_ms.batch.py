"""Device ms a batch of the work launched in the program's ``nms`` span
(ops/nms.py ``_nms_and_compact``: class offsets, ``nms_mask``, compaction).

Moves ``images_per_s``."""

from portbench.layers._program import device_ms


def read(run):
    return device_ms(run, "nms")
