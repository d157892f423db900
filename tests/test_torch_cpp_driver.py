"""The C++ driver of ``deployment/libtorch`` and its op library
(``yolort_tpu_torch/csrc/torch_ops.cpp``).

On the card (``cuda`` marker: ``python -m pytest --noconftest
tests/test_torch_cpp_driver.py -m cuda``) the gate
``deployment/libtorch/smoke.py`` runs whole: an AOTInductor package of a
fabricated yolov5s checkpoint @640, the op library and the driver built
with g++, the driver's readback bit-identical to the same package loaded
in Python, its launch plans equal to the Python ones and its launches
exactly the default route's.  Here, on the CPU: the kernel shapes the gate
asks the plans at, and the build's refusal without a CUDA toolkit."""

import importlib.util
from pathlib import Path

import pytest
import torch

from yolort_tpu_torch.models.yolo import YOLO

ROOT = Path(__file__).resolve().parents[1]


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_plan_shapes_are_the_main_path_tables():
    smoke = _load("deployment/libtorch/smoke.py", "libtorch_smoke")
    m = YOLO(0.33, 0.125, device="cpu")  # yolov5s's head geometry: 80 classes, 3 anchors
    shapes = smoke.plan_shapes(m, 1, (640, 640))
    # stage 1: 25,200 anchors in rows of 128; stage 2: 4104 x 80 pairs
    assert shapes == dict(batch=1, tables=[197, 2565], fetch=[(512, 1, 4096)], C=255)
    m.pre_nms_topk = 512
    assert smoke.plan_shapes(m, 8, (640, 640))["tables"] == [197, 325]


def test_the_build_refuses_without_a_cuda_toolkit(monkeypatch):
    from torch.utils import cpp_extension

    from yolort_tpu_torch.ops.cuda import _build_cpp

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="CUDA toolkit"):
        _build_cpp.cxx_flags()


@pytest.mark.cuda
def test_cpp_driver_gate(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = _load("deployment/libtorch/smoke.py", "libtorch_smoke").main(str(tmp_path))
    assert out["detections"] > 0
    assert out["launches"] == {k: n * out["runs"] for k, n in out["per_run"].items()}


def test_compile_builds_each_object_once_and_reports_a_failure(monkeypatch, tmp_path):
    """The g++ step (``_build_cpp.Compile``): an object per source, reused
    while the source is unchanged, a failure raised with the compiler's
    output (sources with no torch header, so this runs without a toolkit)."""
    from torch.utils import cpp_extension

    from yolort_tpu_torch.ops.cuda import _build_cpp

    monkeypatch.setattr(cpp_extension, "CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build_cpp, "BUILD_DIR", tmp_path / "build")
    good, bad = tmp_path / "good.cpp", tmp_path / "bad.cpp"
    good.write_text("int yt_answer() { return 42; }\n")
    bad.write_text("int yt_broken( { }\n")
    assert _build_cpp.Compile([good]).wait() > 0
    assert _build_cpp.object_path(good).exists()
    assert _build_cpp.Compile([good]).jobs == {}
    with pytest.raises(RuntimeError, match="bad_"):
        _build_cpp.Compile([bad]).wait()
    assert not _build_cpp.object_path(bad).exists()
