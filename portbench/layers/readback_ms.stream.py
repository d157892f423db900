"""Host ms a batch in the program's ``readback`` span (``YOLOv5._unpack``:
the wait for the card, the copies to the host, the numpy slicing).

Moves ``frames_per_s``."""

from portbench.layers._program import host_ms


def read(run):
    return host_ms(run, "readback")
