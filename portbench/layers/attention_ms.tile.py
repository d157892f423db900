"""Device ms a batch of the work launched while the program's
``attention`` span (yolov5ts's ``TransformerBlock``) was the innermost.

Moves ``images_per_s``."""

from portbench.layers._attention import attention_ms


def read(run):
    return attention_ms(run)
