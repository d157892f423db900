"""Share of the network's calls (``Detector.head_outputs``, models/yolo.py)
that replayed a CUDA graph rather than launching the network's kernels
one by one: 100 x the sum of the ``graph_replayed`` counts over their
number, in the traced window, in %.

Moves ``frames_per_s``."""

from portbench.layers._graphs import graph_replay_pct


def read(run):
    return graph_replay_pct(run)
