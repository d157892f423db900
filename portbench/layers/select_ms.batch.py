"""Device ms a batch of the work launched in the program's ``select`` span
(ops/nms.py: both top-k selections, the segment gather, sigmoids, box
decode, the candidates' gather).

Moves ``images_per_s``."""

from portbench.layers._program import device_ms


def read(run):
    return device_ms(run, "select")
