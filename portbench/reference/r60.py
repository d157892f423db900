"""The reference network of a configuration without a ``reference`` key:
ultralytics' r6.0 layouts (``models.build``: ``FModel`` for P3-P5,
``FModelP6`` for P3-P6), through the contract in ``portbench/spec.py``."""

from __future__ import annotations

from portbench.reference import models


def build(cfg: dict):
    return models.build(cfg["p6"], cfg["nc"], cfg["depth_multiple"], cfg["width_multiple"],
                        cfg["anchors"])


head_logits = models.head_logits
save_checkpoint = models.save_checkpoint
