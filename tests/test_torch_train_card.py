"""The port's train step on the card against the CPU (``cuda``-marked:
skips without a card), and the CPU step's own determinism.  No JAX
here, so the file runs on the card's machine:
``python -m pytest --noconftest tests/test_torch_train_card.py -m cuda``.

Tolerances (card vs CPU, TF32 off): loss terms rtol 1e-4; every gradient
leaf within 1e-3, every param after the step within 1e-5, of the leaf's
largest |value| on the CPU: two devices' f32 convolutions reduce in
different orders through ~60 layers."""

import numpy as np
import pytest
import torch

from yolort_tpu_torch.models._bridge import params_from_jax, params_to_jax
from yolort_tpu_torch.models.yolo import YOLO
from yolort_tpu_torch.trainer.task import DefaultTask, TrainState

NC = 8


def _batch(seed: int):
    rng = np.random.default_rng(seed)
    images = rng.random((2, 64, 64, 3)).astype(np.float32)
    targets = np.zeros((2, 4, 5), np.float32)
    targets[..., 0] = rng.integers(0, NC, (2, 4))
    targets[..., 1:3] = rng.uniform(0.1, 0.9, (2, 4, 2))
    targets[..., 3:5] = rng.uniform(0.05, 0.5, (2, 4, 2))
    mask = np.arange(4)[None, :] < np.asarray([3, 2])[:, None]
    return images, targets, mask


def _step(start, device):
    """One SGD step on ``device`` from the params tree ``start``: (loss
    terms, gradient tree, params tree after)."""
    model = params_from_jax(start, YOLO(0.33, 0.125, device=device, num_classes=NC)).trainable()
    task = DefaultTask(model, lr=0.01, momentum=0.937, weight_decay=5e-4)
    state = TrainState(model, *task.make_optimizer())
    state, metrics = task.train_step(state, *(torch.from_numpy(a).to(device) for a in _batch(0)))
    return ({k: float(v) for k, v in metrics.items()},
            params_to_jax(model, leaf=lambda q: q.grad), params_to_jax(model))


def _worst(want, got, path=""):
    out = [(0.0, path)]
    for key, a in want.items():
        if isinstance(a, dict):
            out.append(_worst(a, got[key], f"{path}/{key}"))
        else:
            scale = float(np.abs(a).max()) or 1.0
            out.append((float(np.abs(a - got[key]).max()) / scale, f"{path}/{key}"))
    return max(out)


@pytest.fixture(scope="module")
def start():
    return params_to_jax(YOLO(0.33, 0.125, device="cpu", num_classes=NC).init_train(0))


def test_cpu_train_step_is_deterministic(start):
    """Two CPU steps from one params tree agree bit for bit (and the tree
    is not moved by them)."""
    first, again = _step(start, "cpu"), _step(start, "cpu")
    assert first[0] == again[0]
    assert _worst(first[1], again[1])[0] == 0.0 and _worst(first[2], again[2])[0] == 0.0
    assert _worst(first[2], start)[0] > 0.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_train_step_card_matches_cpu(cuda_device, start):
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    (lc, gc, pc), (lg, gg, pg) = _step(start, "cpu"), _step(start, cuda_device)
    for key in lc:
        np.testing.assert_allclose(lg[key], lc[key], rtol=1e-4, err_msg=key)
    assert _worst(gc, gg)[0] <= 1e-3, _worst(gc, gg)
    assert _worst(pc, pg)[0] <= 1e-5, _worst(pc, pg)
