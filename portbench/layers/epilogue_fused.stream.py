"""Share of the network's biased float convs (``ops/blocks.py`` Conv and
Conv2dOnly) whose bias add and activation ran as the program's one
in-place ``bias_act`` pass rather than ATen's add and activation: 100 x
the ``epilogue_fused`` counts over ``epilogue_fused`` + ``epilogue_plain``,
summed over the traced window, in %.

Moves ``frames_per_s``."""

from portbench.layers._epilogue import epilogue_fused_pct


def read(run):
    return epilogue_fused_pct(run)
