"""Idle device ms a batch whose gap began anywhere else: the program's
``stack``, ``upload`` or ``readback``, its ``request`` outside those, or
between calls.  With ``idle_launch_ms`` it adds up to the window's idle.

Moves ``images_per_s``."""

from portbench.layers._program import idle_ms


def read(run):
    return idle_ms(run, False)
