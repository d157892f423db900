"""Host ms a batch in the program's ``stack`` span (``YOLOv5.__call__``: the
frames checked and grouped, ``np.stack``; per-frame ``from_numpy`` on the
``fixed_shape`` path).

Moves ``frames_per_s``."""

from portbench.layers._program import host_ms


def read(run):
    return host_ms(run, "stack")
