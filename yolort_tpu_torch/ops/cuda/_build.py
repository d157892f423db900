"""Build and load the port's hand-written Hopper kernels.

All sources in ``yolort_tpu_torch/csrc/`` go through one ``nvcc`` call into
one shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/yolort_tpu_torch/`` beside the package (a directory
``.gitignore`` lists), named by a hash of the sources and flags, so an edit
rebuilds and an unchanged tree reuses it.  Nothing is built at import: the
first kernel launch builds.  A missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "yolort_tpu_torch"
SOURCES = ("nms_mask.cu", "bisect_count.cu", "row_fetch.cu")
# -fmad=false: no contraction of a*b+c, so the NMS IoU rounds per operation
# exactly as the plain version does (the sources also use the _rn
# intrinsics); -Xptxas -v writes registers/spills to the build log
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "yt_nms_mask": (_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P),
    "yt_bisect_count": (_P, _I, _I, _I, _I, _P, _P, _P, _P),
    "yt_row_fetch": (_P, _P, _P, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_loaded: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); cannot build the kernels")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found at {nvcc}; cannot build the kernels")
    return str(nvcc)


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libyolort_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    The compiler's output (``-Xptxas -v``) is kept in a ``.log`` beside it."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *(str(CSRC_DIR / s) for s in SOURCES)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call in a process."""
    with _lock:
        lib = _loaded.get("lib")
        if lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _loaded["lib"] = lib
        return lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
