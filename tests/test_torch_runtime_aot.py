"""The exported serving pipeline (``yolort_tpu_torch/runtime/aot.py``) on the
CPU, against the live pipeline and against the JAX package's artifact.

- ``export_aot`` -> ``load_aot`` -> ``predict`` on every ``row_gather``
  route gives exactly the live ``_pipeline_fn``'s outputs (one program,
  the same ops); the artifact holds the program, its text (naming the
  ``yolort_tpu`` ops) and ``meta.json`` with the input spec and device.
- With the same weights (``params_from_jax``, head biases shifted so that
  the candidates are no near-ties), its detections match the JAX package's
  ``export_aot`` -> ``load_aot`` -> ``predict`` on the same frames at the
  JAX test's tolerance (tests/test_runtime_aot.py: boxes rtol 1e-3 / atol
  1e-4, scores rtol 1e-3 / atol 1e-5), detection by detection; the JAX
  side runs the cell path with bisect selection, as the port does.
- The flatten path (``classes_per_anchor``) and the decoded path (an
  ``Ensemble``) export too, equal to their live pipelines.
- A wrong input shape raises "does not match exported spec"; an artifact
  loads and serves in a fresh process that builds no model; one naming a
  device the process lacks raises; an int8-quantized model does not export.
- The card's cases are in tests/test_torch_runtime_card.py (no JAX).
"""

import json
import subprocess
import sys
import zipfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import JaxCellModel, assert_detections_match, tiny_pair
from yolort_tpu.runtime import aot as JA
from yolort_tpu_torch.runtime.aot import _pipeline_fn, export_aot, load_aot, plan_for

ROOT = Path(__file__).resolve().parents[1]
HW = (96, 96)
BATCH = 2
CONFIG = dict(score_thresh=0.25, pre_nms_topk=512)
ROUTES = ("pallas_bisect", "pallas_lookup", "pallas_full")


def frames(seed: int, n: int, hw=HW) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def pair():
    return tiny_pair(seed=3, head_shift=7.0, **CONFIG)


@pytest.fixture(scope="module")
def exported(pair, tmp_path_factory):
    _, _, tm = pair
    path = str(tmp_path_factory.mktemp("aot") / "model.ytpt")
    export_aot(tm, path, batch_size=BATCH, input_hw=HW, meta={"note": "test"})
    return path


def test_artifact_holds_program_text_and_meta(exported):
    with zipfile.ZipFile(exported) as zf:
        assert set(zf.namelist()) == {"program.pt2", "meta.json", "program.txt"}
        meta = json.loads(zf.read("meta.json"))
        text = zf.read("program.txt").decode()
    assert meta["batch_size"] == BATCH and meta["input_hw"] == list(HW)
    assert meta["dtype"] == "float32" and meta["canvas_hw"] == list(HW)
    assert meta["device"] == "cpu" and meta["torch_version"] == torch.__version__
    assert meta["note"] == "test"
    for op in ("fused_cells_stage1", "bisect_count", "row_fetch", "nms_mask"):
        assert f"torch.ops.yolort_tpu.{op}.default" in text


@pytest.mark.parametrize("route", ROUTES)
def test_export_load_predict_is_the_live_pipeline(pair, tmp_path, route):
    _, _, tm = pair
    tm.row_gather = route
    try:
        path = export_aot(tm, str(tmp_path / f"{route}.ytpt"), batch_size=BATCH, input_hw=HW)
        pred = load_aot(path)
        raw = frames(1, BATCH)
        got = pred(raw)
        with torch.no_grad():
            live = _pipeline_fn(tm, plan_for(HW), torch.float32)(torch.from_numpy(raw))
    finally:
        tm.row_gather = ROUTES[0]
    assert all(torch.equal(a, b) for a, b in zip(got, live))
    outs = pred.predict(raw)
    for i, d in enumerate(outs):
        n = int(live[3][i])
        assert n > 0
        np.testing.assert_array_equal(d["boxes"], live[0][i, :n].numpy())
        np.testing.assert_array_equal(d["scores"], live[1][i, :n].numpy())
        np.testing.assert_array_equal(d["labels"], live[2][i, :n].numpy().astype(np.int64))
        assert d["labels"].dtype == np.int64


@pytest.mark.parametrize("path", ["classes_per_anchor", "ensemble"])
def test_the_flatten_and_decoded_paths_export(pair, tmp_path, path):
    """The flatten path (``classes_per_anchor``) and the decoded path (an
    ``Ensemble``'s pooled predictions) export and reload as the cell path
    does: the program's detections equal the live pipeline's."""
    from yolort_tpu_torch.models.ensemble import Ensemble

    _, _, tm = pair
    model = tm
    if path == "classes_per_anchor":
        tm.classes_per_anchor = 4
    else:
        model = Ensemble([tm, tiny_pair(seed=4, head_shift=7.0, **CONFIG)[2]])
    try:
        pred = load_aot(export_aot(model, str(tmp_path / f"{path}.ytpt"), batch_size=BATCH,
                                   input_hw=HW))
        raw = frames(7, BATCH)
        got = pred(raw)
        with torch.no_grad():
            live = _pipeline_fn(model, plan_for(HW), torch.float32)(torch.from_numpy(raw))
    finally:
        tm.classes_per_anchor = None
    assert all(torch.equal(a, b) for a, b in zip(got, live))
    assert int(live[3].min()) > 0
    assert "fused_cells_stage1" not in str(pred.exported.graph)  # neither path has stage 1


def test_exported_predictions_match_the_jax_artifact(pair, exported, tmp_path):
    jm, params, _ = pair
    jpath = str(tmp_path / "jax.ytpu")
    JA.export_aot(JaxCellModel(jm), params, jpath, batch_size=BATCH, input_hw=HW,
                  dtype=jnp.float32, platforms=("cpu",))
    raw = frames(2, BATCH)
    want = JA.load_aot(jpath).predict(raw)
    got = load_aot(exported).predict(raw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_detections_match(g, w, f"image {i}")


def test_shape_mismatch_error(exported):
    pred = load_aot(exported)
    with pytest.raises(ValueError, match="does not match exported spec"):
        pred(np.zeros((1, *HW, 3), np.uint8))
    with pytest.raises(ValueError, match="does not match exported spec"):
        pred(np.zeros((BATCH, 64, 96, 3), np.uint8))


def test_artifact_serves_in_a_fresh_model_free_process(exported, tmp_path):
    raw = frames(3, BATCH)
    np.save(tmp_path / "raw.npy", raw)
    code = (
        "import sys, json, numpy as np, torch\n"
        "torch.set_num_threads(1)  # as this process: the same conv arithmetic\n"
        "from yolort_tpu_torch.runtime.aot import load_aot\n"
        "p = load_aot(sys.argv[1])\n"
        "out = p(np.load(sys.argv[2]))\n"
        "np.savez(sys.argv[3], *[t.numpy() for t in out])\n"
        "jax = [m for m in sys.modules if m.split('.')[0] in ('jax', 'yolort_tpu')]\n"
        "print(json.dumps({'meta': p.meta, 'jax': jax}))\n"
    )
    res = subprocess.run([sys.executable, "-c", code, exported, str(tmp_path / "raw.npy"),
                          str(tmp_path / "out.npz")], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    info = json.loads(res.stdout.strip().splitlines()[-1])
    assert info["meta"]["device"] == "cpu" and info["jax"] == []
    with np.load(tmp_path / "out.npz") as got:
        want = load_aot(exported)(raw)
        for i, t in enumerate(want):
            np.testing.assert_array_equal(got[f"arr_{i}"], t.numpy())


def test_an_absent_device_raises(exported, tmp_path):
    moved = tmp_path / "moved.ytpt"
    with zipfile.ZipFile(exported) as src, zipfile.ZipFile(moved, "w") as dst:
        for name in src.namelist():
            data = src.read(name)
            if name == "meta.json":
                data = json.dumps({**json.loads(data), "device": "cuda:99"}).encode()
            dst.writestr(name, data)
    with pytest.raises(RuntimeError, match="cuda:99"):
        load_aot(str(moved))


def test_a_quantized_model_does_not_export(pair, tmp_path):
    import copy

    from yolort_tpu_torch.ops.library import QCONV_OPS
    from yolort_tpu_torch.ops.quantization import calibrate_activations, quantize_compute_params

    _, _, tm = pair
    q = copy.deepcopy(tm)
    canvas = torch.from_numpy(frames(4, 1)).float() / 255.0
    q = quantize_compute_params(calibrate_activations(q, [canvas]))
    with pytest.raises(NotImplementedError, match=QCONV_OPS[0]):
        export_aot(q, str(tmp_path / "q.ytpt"), batch_size=1, input_hw=HW)


def test_a_cpu_artifact_moved_to_the_cpu_is_the_same_program(exported):
    """``load_aot(path, device=...)`` moves the program
    (``move_to_device_pass``); to the device it was exported on, that is the
    identity.  A device the process lacks raises."""
    raw = frames(8, BATCH)
    want = load_aot(exported)(raw)
    moved = load_aot(exported, device="cpu")
    assert moved.device == torch.device("cpu")
    got = moved(raw)
    assert int(want[3].min()) > 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="not in this process"):
            load_aot(exported, device="cuda")
