"""The least work of yolov5ts's attention block (``C3TR``'s
``TransformerBlock``: a position Linear, then ``n`` layers of q/k/v
Linears, ``nn.MultiheadAttention`` and ``fc2(fc1(x))``), for the
``attention_roofline`` reader.

Operations, a multiply-add as 2, for ``tokens`` tokens of ``width``
channels in images of ``per_image`` tokens each:

* the C x C products a token: the position Linear, and in each layer q,
  k and v (each folds into its input projection, with the softmax
  scale), the output projection, and ``fc2 . fc1`` (one product): 1 + 5n;
* QK^T and AV, each ``per_image`` x C multiply-adds a token a layer:
  4 . tokens . per_image . C . n.

Bytes: the block's input map read once and its output map written once,
and the weights read once a call (1 + 5n C x C matrices and the position
bias).
"""

from __future__ import annotations

from typing import Tuple


def block_width(cfg: dict) -> int:
    """C3TR's inner width: half of the configuration's 1024-channel stage
    (``make_divisible(1024 x width_multiple, 8) // 2``)."""
    v = 1024 * float(cfg["width_multiple"])
    c = max(8, int(v + 4) // 8 * 8)
    c = c + 8 if c < 0.9 * v else c
    return c // 2


def layers(cfg: dict) -> int:
    """The TransformerLayers of the block: ``C3TR``'s depth 3, gained."""
    return max(round(3 * float(cfg["depth_multiple"])), 1)


def work(tokens: int, calls: int, per_image: int, width: int, n: int,
         elem_bytes: int) -> Tuple[float, float]:
    """(bytes, operations) of ``calls`` calls of the block over ``tokens``
    tokens in all."""
    ops = 2.0 * tokens * width ** 2 * (1 + 5 * n) + 4.0 * tokens * per_image * width * n
    nbytes = (2.0 * tokens * width + calls * (width ** 2 * (1 + 5 * n) + width)) * elem_bytes
    return nbytes, ops
