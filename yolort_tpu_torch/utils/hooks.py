"""Intermediate-activation taps of a YOLO model, by forward hooks.

Port of ``yolort_tpu/utils/hooks.py``: the same names (``backbone.{i}``
for each backbone layer, ``pan.{i}`` for each PAN output, ``head.{i}``
for each head level) and the same ``return_layers``.  Tensors come back in
the port's layout: backbone and PAN outputs (B, C, H, W) channels_last,
head outputs (B, H, W, A*(5+nc)).
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch


class FeatureExtractor:
    """Collect named intermediate activations of a YOLO model.

    Example:
        fx = FeatureExtractor(model)
        feats = fx(images)   # {'backbone.0': ..., 'pan.0': ..., 'head.0': ...}

    Each call registers forward hooks on the model's backbone layers, PAN
    and head, runs ``model.head_outputs(images)`` and removes every hook
    before it returns or raises, so the model serves afterwards exactly as
    before."""

    def __init__(self, model, return_layers: Sequence[str] = ("backbone", "pan", "head")):
        self.model = model
        self.return_layers = set(return_layers)

    def __call__(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        out: Dict[str, torch.Tensor] = {}

        def keep(name):
            def hook(module, inputs, output):
                out[name] = output
            return hook

        def keep_each(prefix):
            def hook(module, inputs, outputs):
                for i, o in enumerate(outputs):
                    out[f"{prefix}.{i}"] = o
            return hook

        handles = []
        try:
            if "backbone" in self.return_layers:
                for i, layer in enumerate(self.model.backbone.children()):
                    handles.append(layer.register_forward_hook(keep(f"backbone.{i}")))
            for name in ("pan", "head"):
                if name in self.return_layers:
                    handles.append(getattr(self.model, name).register_forward_hook(
                        keep_each(name)))
            with torch.no_grad():
                self.model.head_outputs(images)
        finally:
            for h in handles:
                h.remove()
        return out
