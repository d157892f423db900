"""Share of the uploads through the program's staging arena
(``YOLOv5.__call__``, models/yolov5.py) that reused it: the ``staged``
count less the arena's allocations (``staging_grown``), over ``staged``,
summed over the traced window, in %.

Moves ``images_per_s``."""

from portbench.layers._staging import staging_reuse_pct


def read(run):
    return staging_reuse_pct(run)
