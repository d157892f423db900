"""Device ms a batch of the kernels launched inside the model's
``head_outputs`` (models/darknet.py, pan.py, head.py, ops/blocks.py).

Moves ``frames_per_s``."""

from portbench.layers._device import per_batch_ms


def read(run):
    return per_batch_ms(run, "portbench.network")
