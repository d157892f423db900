"""The export CLI (``python -m yolort_tpu_torch.tools.export_model``) on the
CPU: a fabricated ultralytics checkpoint (tests/torch_fixture.py) exported
with ``--device cpu --format exported``, loaded and served: its detections
equal the live pipeline of the same checkpoint's model; the ``.npz`` path
takes ``--arch`` (and refuses to run without it)."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_fixture import make_checkpoint
from yolort_tpu_torch.models._bridge import params_to_jax
from yolort_tpu_torch.models._checkpoint import save_params
from yolort_tpu_torch.runtime.aot import _pipeline_fn, load_aot, plan_for
from yolort_tpu_torch.tools.export_model import build_model, cli_main, parse_args

ROOT = Path(__file__).resolve().parents[1]
HW = ["64", "64"]


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("cli") / "fixture_n.pt"
    make_checkpoint(str(path), nc=7, dm=0.33, wm=0.25, seed=1)
    return path


def _args(checkpoint, out, *extra):
    return ["--checkpoint_path", str(checkpoint), "--output_path", str(out), "--device", "cpu",
            "--format", "exported", "--batch_size", "2", "--image_size", *HW,
            "--dtype", "float32", "--score_thresh", "0.001", *extra]


def _live(argv, raw):
    model = build_model(parse_args(argv))
    with torch.no_grad():
        return _pipeline_fn(model, plan_for((64, 64)), torch.float32)(torch.from_numpy(raw))


def test_cli_exports_a_checkpoint_that_loads_and_predicts(checkpoint, tmp_path):
    out = tmp_path / "model.ytpt"
    argv = _args(checkpoint, out)
    res = subprocess.run([sys.executable, "-m", "yolort_tpu_torch.tools.export_model", *argv],
                         cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert f"exported: {out}" in res.stdout
    pred = load_aot(str(out))
    assert pred.meta["device"] == "cpu" and pred.meta["checkpoint"] == str(checkpoint)
    assert pred.meta["batch_size"] == 2 and pred.meta["score_thresh"] == 0.001
    raw = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    dets = pred.predict(raw)
    live = _live(argv, raw)
    # the CLI ran in another process, with its own thread count: the convs
    # may sum in another order, so the boxes and scores agree to f32 ulps
    for i, d in enumerate(dets):
        n = int(live[3][i])
        assert n > 0 and len(d["boxes"]) == n
        np.testing.assert_allclose(d["boxes"], live[0][i, :n].numpy(), rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(d["scores"], live[1][i, :n].numpy(), rtol=1e-5, atol=1e-6)


def test_cli_takes_an_npz_with_its_arch(checkpoint, tmp_path):
    model = build_model(parse_args(_args(checkpoint, tmp_path / "unused")))
    npz = tmp_path / "fixture_n.npz"
    save_params(str(npz), params_to_jax(model), {"num_classes": 7})
    out = cli_main(_args(npz, tmp_path / "npz.ytpt", "--arch", "yolov5_darknet_pan_n_r60"))
    raw = np.random.default_rng(1).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    got = load_aot(out)(raw)
    want = _live(_args(checkpoint, tmp_path / "unused"), raw)
    assert torch.equal(got[3], want[3])
    torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=1e-6)
    with pytest.raises(SystemExit, match="--arch"):
        cli_main(_args(npz, tmp_path / "no_arch.ytpt"))
