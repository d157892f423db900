"""Detections kept (the program's ``kept`` counter) over the pairs that
entered NMS (``candidates``), summed over the traced window, in %.

Moves ``frames_per_s``."""

from portbench.layers._program import nms_yield_pct


def read(run):
    return nms_yield_pct(run)
