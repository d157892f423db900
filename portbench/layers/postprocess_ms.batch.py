"""Device ms a batch of the kernels launched inside the model's
``postprocess`` (ops/nms.py, ops/select.py and the serving kernels).

Moves ``images_per_s``."""

from portbench.layers._device import per_batch_ms


def read(run):
    return per_batch_ms(run, "portbench.postprocess")
