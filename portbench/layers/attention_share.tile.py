"""The attention block's device time, as ``attention_ms.tile`` reads it,
over the network's (``network_ms.batch``'s ``portbench.network``), in %.

Moves ``images_per_s``."""

from portbench.layers._attention import attention_share_pct


def read(run):
    return attention_share_pct(run)
