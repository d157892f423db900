#!/usr/bin/env python3
"""Build the C++ driver (``main.cpp``) and the op library it loads
(``yolort_tpu_torch/csrc/torch_ops.cpp``, with the kernel library under it)
with ``g++`` against the installed torch wheel, into
``build/yolort_tpu_torch/``; prints their paths and the seconds each took.

    python deployment/libtorch/build.py

Needs g++, the CUDA toolkit (nvcc, headers) and torch built for CUDA; no
cmake or ninja.  An unchanged tree reuses what is built.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from yolort_tpu_torch.ops.cuda import _build_cpp  # noqa: E402
from yolort_tpu_torch.ops.cuda._build import BUILD_DIR  # noqa: E402

DRIVER_SOURCE = Path(__file__).resolve().parent / "main.cpp"
SOURCES = (_build_cpp.TORCH_OPS_SOURCE, DRIVER_SOURCE)


def start_compile() -> "_build_cpp.Compile":
    """Both C++ sources' g++ compiles, started in the background."""
    return _build_cpp.Compile(SOURCES)


def driver_path() -> Path:
    return BUILD_DIR / f"yolort_libtorch_driver_{_build_cpp.object_path(DRIVER_SOURCE).stem}"


def build(compiled: "_build_cpp.Compile" = None) -> dict:
    """Build the kernel library, the op library and the driver (both C++
    sources compiled by ``compiled``, a ``Compile`` of ``SOURCES`` already
    started, or by a new one, while nvcc builds the kernels); returns the
    paths and the seconds of the kernel build, the compile and the links."""
    from yolort_tpu_torch.ops.cuda import _build

    compiled = compiled or start_compile()
    t0 = time.perf_counter()
    _build.build()
    t1 = time.perf_counter()
    compile_s = compiled.wait()
    t2 = time.perf_counter()
    ops = _build_cpp.build_ops_library(compiled)
    t3 = time.perf_counter()
    driver = _build_cpp.link([_build_cpp.object_path(DRIVER_SOURCE)], driver_path(), ["-ldl"],
                             shared=False)
    return dict(ops=ops, driver=driver, kernels_s=t1 - t0, compile_s=compile_s,
                ops_link_s=t3 - t2, driver_link_s=time.perf_counter() - t3)

if __name__ == "__main__":
    out = build()
    print(f"op library {out['ops']}\ndriver {out['driver']}\nkernels {out['kernels_s']:.1f} s, "
          f"g++ compile {out['compile_s']:.1f} s (both sources in parallel), links "
          f"{out['ops_link_s']:.1f} s / {out['driver_link_s']:.1f} s (0 where built before)")
