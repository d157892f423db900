"""Ahead-of-time export of the whole serving pipeline, and its predictor.

Port of ``yolort_tpu/runtime/aot.py``.  The uint8-frames-to-detections
pipeline (normalise, letterbox by a fixed plan, network, cell-path
postprocess) is traced once by ``torch.export`` on the model's device;
the kernels are the dispatcher ops of ``ops/library.py``, so the traced
program calls ``torch.ops.yolort_tpu.*`` and launches the same kernels as
the eager model.  Two artifacts:

  * ``export_aot``: a zip of ``program.pt2`` (``torch.export.save``, the
    weights inside it), ``meta.json`` (the input spec, the device, the
    torch version) and ``program.txt`` (the exported program's text).
    ``load_aot`` / ``AOTPredictor`` serve it on the device it names, or
    on another device the caller names (the program moved there).
  * ``export_aoti_package``: an AOTInductor package (``.pt2``), the
    weights baked in, compiled for the model's device: what the C++ driver
    of ``deployment/libtorch`` loads without Python, and what
    ``torch._inductor.aoti_load_package`` loads in Python.

An int8-quantized model does not export yet: its qconv kernels are not
ops (``ops.library.QCONV_OPS``).  It streams (``runtime/streaming.py``),
which exports nothing.
"""

from __future__ import annotations

import copy
import io
import itertools
import json
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from yolort_tpu_torch.models.transform import LetterboxPlan, letterbox_batch, make_plan
from yolort_tpu_torch.ops import blocks
from yolort_tpu_torch.ops.library import QCONV_OPS

FLOAT_DTYPES = (torch.float32, torch.bfloat16)


class _Pipeline(nn.Module):
    """uint8 (B, H, W, 3) frames -> (boxes (B, D, 4) f32, scores (B, D) f32,
    labels (B, D) i32, num (B,) i32) in canvas coordinates: normalised in
    ``dtype``, letterboxed by ``plan``, then the model, as the JAX
    package's exported function composes them (no box rescale)."""

    def __init__(self, model: nn.Module, plan: LetterboxPlan, dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.plan = plan
        self.dtype = dtype

    def forward(self, raw_u8: torch.Tensor):
        imgs = raw_u8.to(self.dtype) * (1.0 / 255.0)
        det = self.model(letterbox_batch(imgs, self.plan))
        return det.boxes, det.scores, det.labels, det.num


def plan_for(input_hw: Tuple[int, int]) -> LetterboxPlan:
    """The letterbox plan of an exported input size: the frame's own sides as
    the resize target, the canvas rounded up to 32 (``aot.py`` of the JAX
    package)."""
    h, w = input_hw
    return make_plan([(h, w)], min_size=min(h, w), max_size=max(h, w))[0]


def model_device(model: nn.Module) -> torch.device:
    """Where a model's weights lie (a quantized model keeps them as buffers)."""
    return next(itertools.chain(model.parameters(), model.buffers())).device


def _float_model(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """``model`` in ``dtype``: itself, or a copy cast to it.  The int8
    buffers of a quantized model stay as they are under the cast."""
    if dtype not in FLOAT_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
    floats = {t.dtype for t in itertools.chain(model.parameters(), model.buffers())
              if t.is_floating_point()}
    return model if floats <= {dtype} else copy.deepcopy(model).to(dtype)


def _refuse_int8(model: nn.Module) -> None:
    """An int8-quantized model raises: its kernels are not dispatcher ops."""
    if any(isinstance(m, blocks._Int8Conv) and m.quantized for m in model.modules()):
        raise NotImplementedError(
            f"an int8-quantized model does not export yet: its kernels "
            f"{', '.join(QCONV_OPS)} are not dispatcher ops (ops/library.py)")


def _pipeline_fn(model: nn.Module, plan: LetterboxPlan, dtype: torch.dtype) -> _Pipeline:
    """``model`` (in ``dtype``) behind the normalisation and the letterbox
    of ``plan``: the module ``export_aot`` traces and the stream runs."""
    return _Pipeline(_float_model(model, dtype), plan, dtype)


def export_program(model: nn.Module, *, batch_size: int = 1,
                   input_hw: Tuple[int, int] = (640, 640), dtype: torch.dtype = torch.float32):
    """(pipeline module, ``torch.export.ExportedProgram``) of ``model``'s
    serving pipeline for uint8 (batch_size, *input_hw, 3) frames, traced on
    the model's device.  An int8-quantized model raises."""
    _refuse_int8(model)
    module = _pipeline_fn(model, plan_for(input_hw), dtype)
    example = torch.zeros(batch_size, *input_hw, 3, dtype=torch.uint8,
                          device=model_device(model))
    with torch.no_grad():
        return module, torch.export.export(module, (example,))


def export_aot(
    model: nn.Module,
    path: str,
    *,
    batch_size: int = 1,
    input_hw: Tuple[int, int] = (640, 640),
    dtype: torch.dtype = torch.float32,
    meta: Optional[Dict[str, Any]] = None,
) -> str:
    """Write the whole uint8-in / detections-out pipeline of a float
    ``Detector`` to one artifact at ``path``: a zip of ``program.pt2``,
    ``meta.json`` and ``program.txt``.  The artifact serves on the device
    the model lies on.  Replaces the reference's ONNX / TensorRT export
    CLIs, as the JAX package's ``export_aot`` does."""
    _, ep = export_program(model, batch_size=batch_size, input_hw=input_hw, dtype=dtype)
    meta_out = {
        "batch_size": batch_size,
        "input_hw": list(input_hw),
        "dtype": str(dtype).replace("torch.", ""),
        "canvas_hw": list(plan_for(input_hw).canvas_hw),
        "device": str(model_device(model)),
        "torch_version": torch.__version__,
        **(meta or {}),
    }
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("program.pt2", buf.getvalue())
        zf.writestr("meta.json", json.dumps(meta_out))
        zf.writestr("program.txt", str(ep))
    return path


def export_aoti_package(
    model: nn.Module,
    path: str,
    *,
    batch_size: int = 1,
    input_hw: Tuple[int, int] = (640, 640),
    dtype: torch.dtype = torch.float32,
) -> str:
    """Compile the serving pipeline ahead of time with AOTInductor into a
    package at ``path`` (``.pt2``), the weights baked in, for the model's
    device, with Inductor's default options (the C++ compiler aside): the
    counterpart of the JAX package's ``export_stablehlo_binary``.  The kernels stay calls of the
    ``yolort_tpu`` ops; a C++ process gets them from ``csrc/torch_ops.cpp``."""
    from torch._inductor import aoti_compile_and_package

    from yolort_tpu_torch.ops.cuda._build_cpp import CXX

    _, ep = export_program(model, batch_size=batch_size, input_hw=input_hw, dtype=dtype)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    # the package's C++ is compiled by the compiler the op library is built
    # with: an inherited CXX may name one without OpenMP's runtime, which
    # Inductor links
    return aoti_compile_and_package(ep, package_path=str(path),
                                    inductor_configs={"cpp.cxx": (None, CXX)})


def load_aot(path: str, device=None) -> "AOTPredictor":
    return AOTPredictor(path, device=device)


class AOTPredictor:
    """Serves an ``export_aot`` artifact.  With no ``device`` it serves on
    the device its ``meta.json`` names, and a device that is absent raises.
    A ``device`` given moves the program there
    (``torch.export.passes.move_to_device_pass``): each kernel is an op with
    a CPU implementation (the plain version) and a CUDA one (the kernel),
    so the moved program dispatches by the device of its tensors."""

    def __init__(self, path: str, device=None):
        with zipfile.ZipFile(path) as zf:
            self.meta = json.loads(zf.read("meta.json").decode())
            program = zf.read("program.pt2")
        recorded = torch.device(self.meta["device"])
        self.device = recorded if device is None else torch.device(device)
        if self.device.type == "cuda" and (not torch.cuda.is_available() or (
                self.device.index or 0) >= torch.cuda.device_count()):
            if device is None:
                raise RuntimeError(f"{path} was exported on {self.device}, which this process "
                                   f"does not have; export it again on a device it has, or "
                                   f"pass device= to move it")
            raise RuntimeError(f"device {str(self.device)!r} is not in this process")
        self.exported = torch.export.load(io.BytesIO(program))
        if device is not None:
            from torch.export.passes import move_to_device_pass

            self.exported = move_to_device_pass(self.exported, str(self.device))
        self.module = self.exported.module()

    def __call__(self, raw_u8):
        """raw_u8: (B, H, W, 3) uint8 frames (numpy or a tensor) matching the
        exported spec.  Returns (boxes, scores, labels, num) padded tensors
        on the artifact's device."""
        b, h, w, _ = raw_u8.shape
        eb, (eh, ew) = self.meta["batch_size"], self.meta["input_hw"]
        if (b, h, w) != (eb, eh, ew):
            raise ValueError(
                f"input shape {(b, h, w)} does not match exported spec {(eb, eh, ew)}")
        x = torch.as_tensor(raw_u8).to(self.device)
        with torch.no_grad():
            return self.module(x)

    def predict(self, raw_u8) -> list:
        """Per-image detection dicts of the padded outputs, as numpy."""
        boxes, scores, labels, num = (t.float().cpu().numpy() if t.is_floating_point()
                                      else t.cpu().numpy() for t in self(raw_u8))
        out = []
        for i in range(boxes.shape[0]):
            n = int(num[i])
            out.append({"boxes": boxes[i, :n], "scores": scores[i, :n],
                        "labels": labels[i, :n].astype(np.int64)})
        return out

    def warmup(self, iters: int = 2) -> None:
        dummy = np.zeros((self.meta["batch_size"], *self.meta["input_hw"], 3), np.uint8)
        for _ in range(iters):
            out = self(dummy)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        del out
