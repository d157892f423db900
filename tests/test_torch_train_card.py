"""The port's train step on the card against the CPU (``cuda``-marked:
skips without a card), and the CPU step's own determinism.  No JAX
here, so the file runs on the card's machine:
``python -m pytest --noconftest tests/test_torch_train_card.py -m cuda``.

Tolerances (card vs CPU, TF32 off): loss terms rtol 1e-4; every gradient
leaf within 1e-3, every param after the step within 1e-5, of the leaf's
largest |value| on the CPU: two devices' f32 convolutions reduce in
different orders through ~60 layers.  The bfloat16 step and the
data-parallel calls on an NCCL group of one rank: see their tests."""

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


def _bf16_step(start, device):
    """One bfloat16 SGD step (params cast, the optimizer made on the cast
    params, bfloat16 images): (loss terms, gradient norm by leaf)."""
    from yolort_tpu_torch.utils.common import cast_floating

    model = cast_floating(params_from_jax(start, YOLO(0.33, 0.125, device=device,
                                                      num_classes=NC)).trainable(),
                          torch.bfloat16)
    task = DefaultTask(model, lr=0.01, momentum=0.937, weight_decay=5e-4)
    state = TrainState(model, *task.make_optimizer())
    images, targets, mask = (torch.from_numpy(a).to(device) for a in _batch(0))
    state, metrics = task.train_step(state, images.to(torch.bfloat16), targets, mask)
    assert {state.optimizer.state[p]["momentum_buffer"].dtype
            for p in model.parameters()} == {torch.bfloat16}
    norms = {}

    def walk(tree, path=""):
        for key, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{path}/{key}")
            else:
                norms[f"{path}/{key}"] = float(np.linalg.norm(v))

    walk(params_to_jax(model, leaf=lambda q: q.grad))
    return {k: float(v) for k, v in metrics.items()}, norms


@pytest.mark.cuda
def test_bf16_step_card_matches_cpu(cuda_device, start):
    """The bfloat16 step on the card against the CPU's: loss terms within
    rtol 1e-2 and the gradients' global norm within 1e-2 relative, a few
    bfloat16 ulps (3.9e-3): the two devices' bfloat16 convolutions round
    their float32 sums at different points (``chip_smoke.py`` phase 9e
    measures yolov5s @640)."""
    (lc, nc), (lg, ng) = _bf16_step(start, "cpu"), _bf16_step(start, cuda_device)
    for key in lc:
        np.testing.assert_allclose(lg[key], lc[key], rtol=1e-2, err_msg=key)
    glob_c, glob_g = (float(np.sqrt(sum(v * v for v in n.values()))) for n in (nc, ng))
    assert abs(glob_g - glob_c) <= 1e-2 * glob_c, (glob_g, glob_c)


@pytest.mark.cuda
def test_data_parallel_infer_on_nccl_world_of_one(cuda_device, start):
    """``make_mesh`` on the card: NCCL, one rank (a ``HashStore``);
    ``data_parallel_infer`` gives the model's own detections with the
    serving kernels' launches, and ``data_parallel_train_step`` the plain
    step's loss terms bit for bit and its params within 1e-6 relative to
    each leaf's largest |value| (measured 8.8e-8; the loss terms agree, so
    the difference is in the backward, whose cuDNN kernels need not be
    deterministic from run to run)."""
    import torch.distributed as dist

    from yolort_tpu_torch.ops import blocks
    from yolort_tpu_torch.ops.cuda import KERNELS, reset_launch_counts
    from yolort_tpu_torch.parallel import (
        data_parallel_infer, data_parallel_train_step, make_mesh, replicate,
    )

    mesh = make_mesh()
    try:
        assert dist.get_backend() == "nccl" and mesh.device == cuda_device
        model = params_from_jax(start, YOLO(0.33, 0.125, device=cuda_device, num_classes=NC,
                                            score_thresh=0.001))
        images = torch.from_numpy(np.random.default_rng(3).random((4, 64, 64, 3),
                                                                   dtype=np.float32))
        infer = data_parallel_infer(replicate(mesh, model), mesh)
        reset_launch_counts()
        got = infer(images)
        torch.cuda.synchronize()
        assert {fn.__name__: fn.launches for fn in KERNELS if fn.launches} == {
            "fused_cells_stage1": 1, "bisect_count": 2, "row_fetch": 1, "nms_mask": 1,
            "bias_act": blocks.biased_float_convs(model)}
        with torch.no_grad():
            want = model(images.to(cuda_device))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        outs = []
        for step in (None, data_parallel_train_step):
            m = params_from_jax(start, YOLO(0.33, 0.125, device=cuda_device,
                                            num_classes=NC)).trainable()
            task = DefaultTask(m, lr=0.01, momentum=0.937, weight_decay=5e-4)
            state = TrainState(m, *task.make_optimizer())
            batch = [torch.from_numpy(a) for a in _batch(0)]
            if step is None:
                state, metrics = task.train_step(state, *(a.to(cuda_device) for a in batch))
            else:
                state, metrics = step(task, mesh)(state, *batch)
            outs.append(({k: float(v) for k, v in metrics.items()}, params_to_jax(m)))
        assert outs[0][0] == outs[1][0]
        assert _worst(outs[0][1], outs[1][1])[0] <= 1e-6
    finally:
        dist.destroy_process_group()
