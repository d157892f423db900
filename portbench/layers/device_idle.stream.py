"""Share of the traced window in which no kernel, copy or fill ran on
the card, in %.

Moves ``frames_per_s``."""

from portbench.layers._device import idle_pct


def read(run):
    return idle_pct(run)
