"""The serving kernels' share of their rooflines, in %: the least time
each ``torch.ops.yolort_tpu.*`` launch of the window could take
(``bounds/<op>.py`` from the launch's shapes, at the card's peaks),
summed, over their device time summed.

Moves ``frames_per_s``."""

from portbench.layers._device import roofline_pct


def read(run):
    return roofline_pct(run)
