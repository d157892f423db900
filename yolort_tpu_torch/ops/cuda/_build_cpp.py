"""Build the port's C++ side with ``g++`` against the torch wheel's headers:
the dispatcher-op library ``csrc/torch_ops.cpp`` (the ``yolort_tpu`` ops
for a process without Python) and, through ``deployment/libtorch/build.py``,
the C++ driver.

No cmake, no ninja: each source is one ``g++ -c`` (a ``Compile`` starts them
all at once and the caller waits when it needs them), then one link.  The flags
come from the installed torch (``include_paths``, ``library_paths``, its
``_GLIBCXX_USE_CXX11_ABI``) and the CUDA toolkit's headers; outputs go to
``build/yolort_tpu_torch/`` (which ``.gitignore`` lists), named by a hash
of the source, the flags and the torch version, at first use.  The op
library links the kernel library of ``_build.py`` and finds it, and
torch's libraries, by rpath.  A failed build raises with the compiler's
output.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

from yolort_tpu_torch.ops.cuda._build import BUILD_DIR, CSRC_DIR

TORCH_OPS_SOURCE = CSRC_DIR / "torch_ops.cpp"
CXX = "g++"  # the C++ compiler of every build here, AOTInductor's included


def cxx_flags() -> List[str]:
    import torch
    from torch.utils import cpp_extension

    if cpp_extension.CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME); cannot build the C++ ops")
    return ["-std=c++17", "-O2", "-fPIC",
            f"-D_GLIBCXX_USE_CXX11_ABI={int(torch._C._GLIBCXX_USE_CXX11_ABI)}",
            *(f"-I{p}" for p in cpp_extension.include_paths()),
            f"-I{Path(cpp_extension.CUDA_HOME) / 'include'}"]


def torch_link_flags() -> List[str]:
    """Link torch's libraries, every one kept (--no-as-needed: the CUDA
    runner of an AOTInductor package registers itself from libtorch_cuda),
    and find them by rpath."""
    from torch.utils import cpp_extension

    lib = cpp_extension.library_paths()[0]
    return [f"-L{lib}", f"-Wl,-rpath,{lib}", "-Wl,--no-as-needed", "-lc10", "-lc10_cuda",
            "-ltorch_cpu", "-ltorch_cuda", "-ltorch", "-Wl,--as-needed"]


def _tag(*parts: bytes) -> str:
    import torch

    h = hashlib.sha256(torch.__version__.encode())
    for p in parts:
        h.update(p)
    return h.hexdigest()[:16]


def object_path(source: Path) -> Path:
    """Where ``source``'s object for these flags and this torch lives."""
    return BUILD_DIR / f"{source.stem}_{_tag(source.read_bytes(), ' '.join(cxx_flags()).encode())}.o"


class Compile:
    """``g++ -c`` of each source whose object is missing, all started at
    once; a thread reaps them, so ``seconds`` is the compile's own time
    however late ``wait`` is called.  ``wait`` returns it and raises on a
    failure."""

    def __init__(self, sources: Iterable[Path]):
        self.t0 = time.perf_counter()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        flags = cxx_flags()
        self.jobs: Dict[Path, Tuple[Path, subprocess.Popen]] = {}
        for src in sources:
            obj = object_path(src)
            if obj.exists():
                continue
            tmp = obj.with_name(f"{obj.name}.{os.getpid()}.tmp")
            self.jobs[obj] = (tmp, subprocess.Popen(
                [CXX, *flags, "-c", "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        self.outputs: Dict[Path, str] = {}
        self.seconds = 0.0
        self._reaper = threading.Thread(target=self._reap, daemon=True)
        self._reaper.start()

    def _reap(self) -> None:
        for obj, (_, proc) in self.jobs.items():
            self.outputs[obj] = proc.communicate()[0]
        self.seconds = time.perf_counter() - self.t0

    def wait(self) -> float:
        self._reaper.join()
        failed = []
        for obj, (tmp, proc) in self.jobs.items():
            if proc.returncode != 0:
                failed.append(f"== {obj.name}: g++ exit {proc.returncode}\n"
                              f"{self.outputs[obj][-6000:]}")
                tmp.unlink(missing_ok=True)
            elif tmp.exists():
                os.replace(tmp, obj)  # atomic: no other process sees a partial object
        if failed:
            raise RuntimeError("g++ failed:\n" + "\n".join(failed))
        return self.seconds


def link(objects: Sequence[Path], out: Path, extra: Sequence[str], shared: bool) -> Path:
    """Link ``objects`` into ``out`` (a shared library or an executable)
    unless it exists."""
    if out.exists():
        return out
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [CXX, *(["-shared"] if shared else []), "-o", str(tmp), *map(str, objects), *extra,
           *torch_link_flags()]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         check=False)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"link of {out.name} failed:\n{res.stdout[-6000:]}")
    os.replace(tmp, out)
    return out


def ops_library_path() -> Path:
    """The op library for the current ``torch_ops.cpp`` and kernel library."""
    from yolort_tpu_torch.ops.cuda import _build

    return BUILD_DIR / (f"libyolort_torch_ops_"
                        f"{_tag(object_path(TORCH_OPS_SOURCE).name.encode(), _build.library_path().name.encode())}.so")


def build_ops_library(compiled: Compile = None) -> Path:
    """Build (or reuse) the kernel library and the op library; returns the
    op library's path.  ``compiled``: a ``Compile`` already started with
    ``TORCH_OPS_SOURCE`` among its sources."""
    from yolort_tpu_torch.ops.cuda import _build

    kernels = _build.build()
    out = ops_library_path()
    if out.exists():
        return out
    (compiled or Compile([TORCH_OPS_SOURCE])).wait()
    return link([object_path(TORCH_OPS_SOURCE)], out,
                [f"-L{kernels.parent}", f"-l:{kernels.name}", f"-Wl,-rpath,{kernels.parent}"],
                shared=True)
