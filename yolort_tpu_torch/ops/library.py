"""The serving routes' kernels as PyTorch dispatcher ops, namespace
``yolort_tpu``.

One op for each kernel entry point the postprocess launches, each with a
fixed schema and three implementations, which its kernel module
(``ops/cuda/*_kernel.py``) registers at its import through ``register``:

  * ``CPU``: the kernel's plain PyTorch version (``*_reference``);
  * ``CUDA``: the kernel's launch on the current stream, with its host-side
    plan, its contiguity and alignment checks and its launch count (the
    ``launches`` attribute of the Python wrapper);
  * fake (``register_fake``): output shapes and dtypes only, for
    ``torch.export``, AOTInductor and ``torch.compile``.

Dispatch is by the inputs' device alone: a CUDA tensor reaches the kernel
or raises, a CPU tensor the plain version.  The Python wrappers check
shapes, dtypes and devices and then call ``torch.ops.yolort_tpu.<op>``, so
an eager call, a CUDA-graph capture, an exported program and an
AOTInductor package launch the same kernel.  Python ``float`` / ``int``
arguments are schema scalars: an exported program records them as
constants.

``csrc/torch_ops.cpp`` defines the same schemas (``SCHEMAS``) with the same
CUDA launches for a process without Python (``deployment/libtorch``); it
is never loaded where this module is.  The int8 conv kernels are not ops
yet: ``QCONV_OPS`` names them for the error an int8 export raises.
"""

from __future__ import annotations

import torch

NAMESPACE = "yolort_tpu"
SCHEMAS = {
    "fused_cells_stage1":
        "fused_cells_stage1(Tensor[] levels, int num_anchors, int kw) -> (Tensor, Tensor, Tensor)",
    "bisect_count": "bisect_count(Tensor table, int k, int thr_bits) -> (Tensor, Tensor, Tensor)",
    "row_fetch": "row_fetch(Tensor table, Tensor idx) -> Tensor",
    "lookup_fetch":
        "lookup_fetch(Tensor table, Tensor off, int k) -> (Tensor, Tensor, Tensor, Tensor)",
    "select_extract": "select_extract(Tensor table, Tensor phys, Tensor p, Tensor is_eq, "
                      "Tensor t, int thr_bits) -> (Tensor, Tensor)",
    "nms_mask": "nms_mask(Tensor boxes, Tensor valid, float iou_thresh, int tile_size, "
                "int stop_after) -> Tensor",
}
# the int8 conv kernels, launched by quantized models, not yet ops
QCONV_OPS = ("qconv1x1", "qconv_kxk", "qconv_grouped")

_LIB = torch.library.Library(NAMESPACE, "DEF")
for _schema in SCHEMAS.values():
    _LIB.define(_schema)


def register(name: str, cpu, cuda, fake, wrapper) -> None:
    """Give the op ``name`` its CPU, CUDA and fake implementations, and
    start the launch count of ``wrapper``, the Python function that calls
    it (its CUDA implementation counts there)."""
    _LIB.impl(name, cpu, "CPU")
    _LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    wrapper.launches = 0


def op(name: str):
    """The dispatcher op ``yolort_tpu::<name>`` (its default overload)."""
    return getattr(getattr(torch.ops, NAMESPACE), name).default
