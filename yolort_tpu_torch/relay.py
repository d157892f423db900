"""Export-surface compatibility layer.

Port of ``yolort_tpu/relay.py``: the reference's relay package reshapes the
torch graph per export backend (yolort/relay/: trace_wrapper.py:37
get_trace_module, logits_decoder.py:10 LogitsDecoder, trt_graphsurgeon.py:179
register_nms).  Here they are views of the one exported program of
``runtime.aot``, under their familiar names.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from yolort_tpu_torch.ops.boxes import cxcywh_to_xyxy


def get_trace_module(model: nn.Module, *, batch_size: int = 1,
                     input_hw: Tuple[int, int] = (640, 640), dtype: torch.dtype = torch.float32):
    """The end-to-end pipeline module and its ``torch.export`` program, the
    analog of tracing the model for LibTorch (trace_wrapper.py:37).

    Returns (module, exported_program): ``module`` takes uint8 (batch_size,
    *input_hw, 3) frames; ``str(exported_program)`` is the text the
    artifact of ``runtime.aot.export_aot`` ships, the kernels in it as
    ``torch.ops.yolort_tpu`` calls."""
    from yolort_tpu_torch.runtime.aot import export_program

    return export_program(model, batch_size=batch_size, input_hw=input_hw, dtype=dtype)


class LogitsDecoder(nn.Module):
    """NMS-free export surface: decoded (boxes xyxy, scores) as the
    reference's LogitsDecoder gives them (relay/logits_decoder.py:10,26), the
    piece a backend-side NMS would consume.  Scores are each class's score
    times the objectness."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, H, W, 3) letterboxed -> boxes (B, Na, 4), scores (B, Na, nc)."""
        pred = self.model.decode(images)  # (B, Na, 5+nc)
        return cxcywh_to_xyxy(pred[..., :4]), pred[..., 5:] * pred[..., 4:5]


def register_nms(*args, **kwargs):
    raise NotImplementedError(
        "register_nms is a TensorRT graph-surgery step (relay/trt_graphsurgeon.py:179); in "
        "yolort_tpu_torch the batched NMS is already inside the exported program (the "
        "yolort_tpu::nms_mask op): export with runtime.aot.export_aot instead."
    )
