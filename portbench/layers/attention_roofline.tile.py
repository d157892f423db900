"""The attention block's share of its roofline, in %: its least time
(``bounds/_attention.py``: the larger of its operations at the dtype's
peak and its unavoidable bytes at the memory rate) over its device time.

Moves ``images_per_s``."""

from portbench.layers._attention import attention_roofline_pct


def read(run):
    return attention_roofline_pct(run)
