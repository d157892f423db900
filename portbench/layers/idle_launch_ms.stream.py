"""Idle device ms a batch whose gap began while the host was in a launching
span of the program (``letterbox``, ``network``, ``postprocess`` and its
children, ``rescale``): the host slower than the card.

Moves ``frames_per_s``."""

from portbench.layers._program import idle_ms


def read(run):
    return idle_ms(run, True)
