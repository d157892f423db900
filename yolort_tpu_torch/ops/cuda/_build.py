"""Build and load the port's hand-written Hopper kernels.

Each source in ``yolort_tpu_torch/csrc/`` is compiled by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The
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
SOURCES = (
    "nms_mask.cu", "bisect_count.cu", "row_fetch.cu", "qconv.cu", "cells_stage1.cu",
    "lookup_fetch.cu", "select_extract.cu", "compact_select.cu",
)
HEADERS = ("tier_rank.cuh",)  # included by the sources; part of the library's hash
# -fmad=false: no contraction of a*b+c, so the NMS IoU and the qconv
# epilogue round per operation exactly as the plain versions do (the
# sources also use the _rn intrinsics); -Xptxas -v writes registers/spills
# to the build log
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *GENCODE, "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "yt_nms_mask": (_P, _P, _P, _P, _I, _I, ctypes.c_float, _I, _I, _P),
    "yt_nms_scratch_rows": (_I, _I, _I),
    "yt_bisect_count": (_P, _I, _I, _I, _I, _P, _P, _P, _I, _I, _P),
    "yt_row_fetch_p": (_P, _P, _P, *(_I,) * 6, _P),
    "yt_qconv1x1": (_P, _P, _P, _P, _F, _P, *(_I,) * 10, _P),
    "yt_qconv_kxk": (_P, _P, _P, _P, _F, _P, *(_I,) * 15, _P),
    "yt_qconv_grouped": (_P, _P, _P, _P, _F, _P, *(_I,) * 13, _P),
    "yt_cells_stage1": (_P, _P, _P, _P, *(_I,) * 9, _F, _I, _P, _P, _P, _P),
    "yt_cells_stage1_plan": (_I, _I, _P),
    "yt_lookup_fetch_variant": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _P),
    "yt_select_extract": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
    "yt_compact_place": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P),
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
    for name in (*SOURCES, *HEADERS):
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libyolort_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless the library for these sources exists.
    The compiler's output (``-Xptxas -v``) is kept in a ``.log`` beside it."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{Path(name).stem}.o" for name in SOURCES]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC_DIR / name)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, obj in zip(SOURCES, objs)
    ]
    logs = [f"== {name}\n{p.communicate()[0]}" for name, p in zip(SOURCES, procs)]
    failed = [(name, p.returncode) for name, p in zip(SOURCES, procs) if p.returncode != 0]
    tmp = out.with_name(f"{tag}.so.tmp")
    if not failed:
        res = subprocess.run([nvcc, *GENCODE, "-shared", "-o", str(tmp), *map(str, objs)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             check=False)
        logs.append(f"== link\n{res.stdout}")
        if res.returncode != 0:
            failed.append(("link", res.returncode))
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "\n".join(logs)
    out.with_suffix(".log").write_text(log)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed {failed}:\n{log[-4000:]}")
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
