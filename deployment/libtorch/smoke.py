#!/usr/bin/env python3
"""C++ driver gate, on the card:

  1. fabricate an ultralytics-layout yolov5s checkpoint
     (``tests/torch_fixture.make_checkpoint``, 80 classes, seed 7);
  2. load it with ``YOLOv5.load_from_yolov5`` on the card, float32;
  3. compile its serving pipeline at batch 1 @640 into an AOTInductor
     package (``runtime.aot.export_aoti_package``);
  4. build the op library and the driver (``build.py``) and run the driver
     on a deterministic uint8 frame, with its readback dumped; the driver
     also prints its launch plans, which must equal the Python ones at the
     package's shapes, and the kernels' launches, which must be exactly
     those of the default route (fused_cells_stage1 1, bisect_count 2,
     row_fetch 1, nms_mask 1 a run);
  5. load the same package in Python (``torch._inductor.aoti_load_package``)
     and run it on the same frame, TF32 off on both sides: the driver's
     boxes, scores, labels and counts must equal it bit for bit (one
     compiled program, one set of kernels).  Prints ``PARITY OK`` and ``SMOKE OK``.

    python deployment/libtorch/smoke.py [--out DIR]

Needs one card; writes into ``DIR`` (default: a new directory under
``build/``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

RUNS = 3
# a run's launches on the default route
PER_RUN = {"fused_cells_stage1": 1, "bisect_count": 2, "row_fetch": 1, "lookup_fetch": 0,
           "select_extract": 0, "nms_mask": 1}


def _load(path: Path, name: str):
    """A module of the checkout loaded by path (an installed package named
    'tests' would shadow the checkout's test directory)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def plan_shapes(yolo, batch: int, input_hw) -> dict:
    """The kernels' shapes in the package: the stage-1 and stage-2
    ``bisect_count`` tables' rows, the stage-2 ``row_fetch`` (row bytes,
    batch, k) and the head's row length."""
    anchors = sum((input_hw[0] // s) * (input_hw[1] // s) for s in yolo.strides) * yolo.num_anchors
    k = min(yolo.pre_nms_topk, anchors * yolo.num_classes)
    k1 = min(yolo.pre_nms_anchors if yolo.pre_nms_anchors is not None else k + 8, anchors)
    return dict(batch=batch, tables=[math.ceil(anchors / 128), math.ceil(k1 * yolo.num_classes / 128)],
                fetch=[(128 * 4, batch, k)], C=yolo.num_anchors * (5 + yolo.num_classes))


def python_plans(shapes: dict) -> dict:
    """The Python launch plans at ``shapes``, laid out as ``yt_ops_plans``
    prints the C++ ones."""
    import torch

    from yolort_tpu_torch.ops.cuda.lookup_kernel import bisect_plan, row_fetch_geometry
    from yolort_tpu_torch.ops.cuda.stage1_kernel import stage1_plan

    b = shapes["batch"]
    return {"bisect_plan": [[b, m, *bisect_plan(b, m)] for m in shapes["tables"]],
            "row_fetch_geometry": [[*f, *row_fetch_geometry(*f)] for f in shapes["fetch"]],
            "stage1_plan": {name: list(stage1_plan(shapes["C"], dt)) for name, dt in
                            (("float32", torch.float32), ("bfloat16", torch.bfloat16))}}


def main(out_dir=None, compiled=None) -> dict:
    """Run the gate; ``compiled`` is a ``_build_cpp.Compile`` of the two C++
    sources already started.  Returns the seconds and counts it printed."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("the C++ driver gate needs a CUDA device")
    # full float32 convolutions and matmuls, as the driver runs them
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from yolort_tpu_torch.models.yolov5 import YOLOv5
    from yolort_tpu_torch.runtime.aot import export_aoti_package

    out = Path(out_dir) if out_dir else Path(tempfile.mkdtemp(dir=ROOT / "build"))
    out.mkdir(parents=True, exist_ok=True)
    ckpt, pkg, inp = out / "fixture_s.pt", out / "yolov5s_fixture_640.pt2", out / "input_u8.bin"
    fixture = _load(ROOT / "tests" / "torch_fixture.py", "torch_fixture")
    fixture.make_checkpoint(str(ckpt), nc=80, dm=0.33, wm=0.5, seed=7)
    m = YOLOv5.load_from_yolov5(str(ckpt), device="cuda", dtype=torch.float32, score_thresh=1e-4)
    t0 = time.perf_counter()
    export_aoti_package(m.model, str(pkg), batch_size=1, input_hw=(640, 640))
    aoti_s = time.perf_counter() - t0
    print(f"[driver] AOTInductor package {pkg.name} compiled in {aoti_s:.1f} s", flush=True)

    built = _load(Path(__file__).resolve().parent / "build.py", "libtorch_build").build(compiled)
    print(f"[driver] built: kernels {built['kernels_s']:.1f} s, g++ compile "
          f"{built['compile_s']:.1f} s, op library link {built['ops_link_s']:.1f} s, driver link "
          f"{built['driver_link_s']:.1f} s", flush=True)
    driver, ops = str(built["driver"]), str(built["ops"])

    shapes = plan_shapes(m.model, 1, (640, 640))
    res = subprocess.run(
        [driver, ops, "--plans", str(shapes["batch"]), str(shapes["C"]),
         ",".join(map(str, shapes["tables"])), ",".join(":".join(map(str, f)) for f in shapes["fetch"])],
        capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"driver --plans exit {res.returncode}:\n{res.stdout}\n{res.stderr}")
    cpp_plans = json.loads(res.stdout.strip().splitlines()[-1])
    py_plans = python_plans(shapes)
    print(f"[driver] launch plans, C++    {json.dumps(cpp_plans)}\n"
          f"[driver] launch plans, Python {json.dumps(py_plans)}", flush=True)
    if cpp_plans != py_plans:
        raise AssertionError("the C++ launch plans differ from the Python ones")

    raw = np.random.default_rng(42).integers(0, 255, (1, 640, 640, 3), dtype=np.uint8)
    raw.tofile(inp)
    t0 = time.perf_counter()
    res = subprocess.run([driver, ops, str(pkg), "1", "640", "640", str(RUNS), str(inp),
                          str(out / "dump")], capture_output=True, text=True, timeout=600)
    run_s = time.perf_counter() - t0
    print(res.stdout + res.stderr, flush=True)
    if res.returncode != 0 or "detections per image:" not in res.stdout:
        raise RuntimeError(f"SMOKE FAIL: the driver exited {res.returncode} without a readback")
    line = next(x for x in res.stdout.splitlines() if x.startswith("launches over"))
    words = line.split(":", 1)[1].split()
    launches = {words[i]: int(words[i + 1]) for i in range(0, len(words), 2)}
    want = {k: n * RUNS for k, n in PER_RUN.items()}
    if launches != want:
        raise AssertionError(f"driver launches {launches}, want {want}")

    runner = torch._inductor.aoti_load_package(str(pkg))
    with torch.no_grad():
        boxes, scores, labels, num = (t.cpu().numpy() for t in runner(torch.from_numpy(raw).cuda()))
    got = {"boxes": np.fromfile(f"{out}/dump.boxes.f32", np.float32).reshape(boxes.shape),
           "scores": np.fromfile(f"{out}/dump.scores.f32", np.float32).reshape(scores.shape),
           "labels": np.fromfile(f"{out}/dump.labels.i32", np.int32).reshape(labels.shape),
           "num": np.fromfile(f"{out}/dump.num.i32", np.int32).reshape(num.shape)}
    for name, want_arr in (("boxes", boxes), ("scores", scores), ("labels", labels), ("num", num)):
        if not np.array_equal(got[name].view(np.uint8), want_arr.view(np.uint8)):
            raise AssertionError(f"PARITY FAIL: the driver's {name} differ from the Python load's")
    n = int(num[0])
    if n <= 0:
        raise AssertionError("no detections to compare")
    print(f"PARITY OK: {n} detections, boxes / scores / labels / counts bit-identical to the "
          f"package loaded in Python", flush=True)
    print("SMOKE OK", flush=True)
    return dict(aoti_s=aoti_s, run_s=run_s, detections=n, launches=launches, runs=RUNS,
                per_run=PER_RUN,
                plans=cpp_plans, **{k: v for k, v in built.items() if k.endswith("_s")})


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="directory for the checkpoint, package and dumps")
    main(ap.parse_args().out)
