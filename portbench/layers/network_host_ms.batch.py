"""Host ms a batch in the program's ``network`` span (``Detector.forward``
around ``head_outputs``): the launch cost of the network.

Moves ``images_per_s``."""

from portbench.layers._program import host_ms


def read(run):
    return host_ms(run, "network")
