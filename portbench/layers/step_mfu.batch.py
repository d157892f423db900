"""The network's FLOPs (counted on the benchmark's reference network at
the cell's canvas, a multiply-add as 2), times the images done in the
traced window, over the window and the configuration's dtype peak, in %.

Moves ``images_per_s``."""

from portbench.layers._device import mfu_pct


def read(run):
    return mfu_pct(run)
