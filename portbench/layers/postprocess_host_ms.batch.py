"""Host ms a batch in the program's ``postprocess`` span (``Detector.forward``
around ``postprocess``), its ``cells``, ``select`` and ``nms`` included.

Moves ``images_per_s``."""

from portbench.layers._program import host_ms


def read(run):
    return host_ms(run, "postprocess")
