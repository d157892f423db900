"""Data-parallel serving and training of the port (``yolort_tpu_torch.parallel``)
on the CPU, against the port's single-process calls and the JAX package's
``parallel`` (mirrors tests/test_parallel.py, test_multiprocess.py and
``__graft_entry__.dryrun_multichip``).

- With no process group the collectives are the identity of one process.
- ``make_mesh`` at world size 1 (gloo, a ``HashStore``): the mesh calls are
  the single-process calls, bit for bit, and each collective is issued
  (counted).
- Two gloo ranks, each a subprocess of its own with a ``FileStore`` under
  ``tmp_path`` and a ``communicate(timeout=...)``: yolov5n's
  ``data_parallel_infer`` equals the single-process call on the whole
  batch, bit for bit; ``data_parallel_train_step`` on an 8-image batch
  whose halves hold different candidate counts matches the port's
  single-process step and JAX's ``data_parallel_train_step`` on a 2-device
  CPU mesh: loss terms rtol 1e-5 (the JAX test's; measured 1.7e-7 against
  JAX's, 1.3e-7 against the one-process step), params 1e-5 relative to
  each leaf's largest |value| (measured 1.2e-10 and 1.7e-13: the ranks'
  gradients are summed in another order than one process sums the
  batch's, and an SGD step moves a leaf little); the two
  ranks' params equal; ``COCOEvaluator`` merges the ranks' shards as one
  process evaluates their union; ``all_reduce_mean`` and the logger's
  meters average over the ranks; a ``model_axis=2`` mesh (data axis 1)
  steps as one process does; ``tools/eval_metric --num_chips 2`` started on
  each rank gives the one-process metrics.
"""

import json
import os
import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import leaf_errors, randomize_convs, to_numpy
from yolort_tpu.models.yolo import YOLO as JaxYOLO
from yolort_tpu.parallel import data_parallel_train_step as jax_dp_step
from yolort_tpu.parallel import make_mesh as jax_make_mesh
from yolort_tpu.parallel import replicate as jax_replicate
from yolort_tpu.parallel import shard_batch as jax_shard_batch
from yolort_tpu.trainer.task import DefaultTask as JaxTask
from yolort_tpu_torch.models._bridge import params_from_jax, params_to_jax
from yolort_tpu_torch.models._checkpoint import load_params
from yolort_tpu_torch.models.yolo import YOLO
from yolort_tpu_torch.parallel import (
    data_parallel_infer, data_parallel_train_step, make_mesh, replicate, shard_batch,
)
from yolort_tpu_torch.parallel import distributed as D
from yolort_tpu_torch.trainer.task import DefaultTask, TrainState

REPO = Path(__file__).resolve().parent.parent
TINY = (0.33, 0.125)
NANO = (0.33, 0.25)
NC = 8
SGD = dict(lr=0.01, momentum=0.9, weight_decay=5e-4)
INFER_CFG = dict(score_thresh=0.25, pre_nms_topk=512)


def train_batch():
    """8 images 64x64; images 0-3 hold 3-4 targets each, images 4-7 one:
    the halves' candidate counts differ."""
    rng = np.random.default_rng(7)
    images = rng.random((8, 64, 64, 3)).astype(np.float32)
    targets = np.zeros((8, 4, 5), np.float32)
    targets[..., 0] = rng.integers(0, NC, (8, 4))
    targets[..., 1:3] = rng.uniform(0.15, 0.85, (8, 4, 2))
    targets[..., 3:5] = rng.uniform(0.1, 0.5, (8, 4, 2))
    mask = np.arange(4)[None, :] < np.asarray([4, 3, 4, 3, 1, 1, 1, 1])[:, None]
    return images, targets, mask


def infer_images():
    return np.random.default_rng(2).random((8, 64, 64, 3)).astype(np.float32)


def make_shard(r):
    """A rank's evaluator shard (tests/test_multiprocess.py's generator)."""
    rng = np.random.default_rng(42 + r)
    preds, tgts = [], []
    for _ in range(6):
        ng = int(rng.integers(1, 5))
        gb = rng.uniform(0, 400, (ng, 2))
        gboxes = np.concatenate([gb, gb + rng.uniform(20, 120, (ng, 2))], 1).astype(np.float32)
        glabels = rng.integers(0, 5, ng)
        nd = int(rng.integers(1, 8))
        j = rng.integers(0, ng, nd)
        dboxes = (gboxes[j] + rng.normal(0, 5, (nd, 4))).astype(np.float32)
        preds.append({"boxes": dboxes, "scores": rng.random(nd).astype(np.float32),
                      "labels": glabels[j]})
        tgts.append({"boxes": gboxes, "labels": glabels})
    return preds, tgts


def eval_argv(root, nano):
    """``tools/eval_metric``'s flags on the CPU over a seeded synthetic COCO
    set of 7 images at batch 4 (the final batch of 3 pads to 4 on two
    ranks) and a ``.npz`` of the nano params."""
    from yolort_tpu_torch.data._helper import create_synthetic_coco
    from yolort_tpu_torch.models._checkpoint import save_params

    img_dir, ann = create_synthetic_coco(str(root / "coco"), num_images=7, num_classes=NC,
                                         seed=9, image_hw=(96, 128))
    npz = str(root / "nano.npz")
    save_params(npz, nano, {"num_classes": NC})
    return ["--checkpoint_path", npz, "--arch", "yolov5_darknet_pan_n_r60", "--image_path",
            str(img_dir), "--annotation_path", str(ann), "--batch_size", "4", "--image_size",
            "128", "--device", "cpu"]


def port_model(dims, params, **kw):
    return params_from_jax(params, YOLO(*dims, device="cpu", num_classes=NC, **kw))


WORKER = textwrap.dedent("""
    import json, os, pickle, sys
    sys.path.insert(0, os.environ["REPO"])
    import numpy as np, torch
    torch.set_num_threads(1)
    from yolort_tpu_torch.data.coco_eval import COCOEvaluator
    from yolort_tpu_torch.models._bridge import params_from_jax, params_to_jax
    from yolort_tpu_torch.models._checkpoint import save_params
    from yolort_tpu_torch.models.yolo import YOLO
    from yolort_tpu_torch.parallel import (data_parallel_infer, data_parallel_train_step,
                                           make_mesh, replicate)
    from yolort_tpu_torch.parallel import distributed as D
    from yolort_tpu_torch.trainer.task import DefaultTask, TrainState
    from yolort_tpu_torch.utils.logger import MetricLogger

    rank, out = int(os.environ["RANK"]), os.environ["OUT"]
    with open(os.path.join(out, "cases.pkl"), "rb") as f:
        cases = pickle.load(f)

    def port_model(dims, params, **kw):
        m = YOLO(*dims, device="cpu", num_classes=cases["nc"], **kw)
        return params_from_jax(params, m)

    mesh = make_mesh(["cpu", "cpu"], init_method=os.environ["INIT"], world_size=2, rank=rank)
    res = {"world": D.get_world_size(), "rank": D.get_rank(), "main": D.is_main_process(),
           "mean": D.all_reduce_mean(float(rank)),
           "objects": D.all_gather_objects({"r": rank}),
           "data": [mesh.data_size, mesh.data_rank]}

    ev = COCOEvaluator()
    ev.update(*cases["shards"][rank])
    ev.synchronize_between_processes()
    res["coco"] = ev.compute()
    logger = MetricLogger()
    logger.update(loss=rank + 1.0)
    logger.update(loss=rank + 3.0)
    logger.synchronize_between_processes()
    res["meter_total"] = logger.loss.total

    # serving: rank 1 starts from other weights, replicate gives it rank 0's
    model = port_model(cases["nano_dims"], cases["nano"], **cases["infer_cfg"])
    if rank == 1:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1.0)
    replicate(mesh, model)
    det = data_parallel_infer(model, mesh)(torch.from_numpy(cases["infer_images"]))
    if rank == 0:
        np.savez(os.path.join(out, "infer.npz"), **det._asdict())

    # training: the global batch's step
    batch = [torch.from_numpy(a) for a in cases["train_batch"]]
    task = DefaultTask(port_model(cases["tiny_dims"], cases["tiny"]).trainable(), **cases["sgd"])
    state = replicate(mesh, TrainState(task.model, *task.make_optimizer()))
    state, metrics = data_parallel_train_step(task, mesh)(state, *batch)
    res["metrics"] = {k: float(v) for k, v in metrics.items()}
    res["step"] = state.step
    save_params(os.path.join(out, f"train{rank}.npz"), params_to_jax(state.model))

    # a model axis of 2: both ranks take the whole batch (data axis 1)
    mesh2 = make_mesh(["cpu", "cpu"], model_axis=2)
    res["mesh2"] = [mesh2.data_size, mesh2.model_size, mesh2.data_rank, mesh2.model_rank]
    task2 = DefaultTask(port_model(cases["tiny_dims"], cases["tiny"]).trainable(),
                        **cases["sgd"])
    state2 = TrainState(task2.model, *task2.make_optimizer())
    state2, m2 = data_parallel_train_step(task2, mesh2)(state2, *(a[:4] for a in batch))
    res["metrics2"] = {k: float(v) for k, v in m2.items()}
    save_params(os.path.join(out, f"model_axis{rank}.npz"), params_to_jax(state2.model))

    # tools/eval_metric on two ranks of its own, started by its flags
    torch.distributed.destroy_process_group()
    from yolort_tpu_torch.tools import eval_metric
    res["eval_metric"] = eval_metric.cli_main(cases["eval_argv"] + [
        "--num_chips", "2", "--rank", str(rank), "--init_method", os.environ["INIT"] + "_eval"])
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
""")


def run_ranks(tmp_path, script: str, world: int = 2):
    """Start ``world`` ranks of ``script`` (gloo, a FileStore rendezvous under
    ``tmp_path``); each rank's stdout on failure."""
    path = tmp_path / "worker.py"
    path.write_text(script)
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = []
    for rank in range(world):
        env = dict(os.environ, REPO=str(REPO), RANK=str(rank), INIT=init, OUT=str(tmp_path),
                   OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, str(path)], env=env, cwd=str(tmp_path),
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def wait_ranks(procs, timeout: int = 300):
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]


@pytest.fixture(scope="module")
def params():
    def init(dims, seed):
        return randomize_convs(JaxYOLO(*dims, num_classes=NC).init(jax.random.PRNGKey(seed)),
                               seed)

    nano = init(NANO, 1)
    for leaf in nano["head"].values():  # candidates above the serving threshold
        b = leaf["b"].reshape(3, -1).copy()
        b[:, 4:] += 7.0
        leaf["b"] = b.reshape(-1)
    return {"nano": nano, "tiny": init(TINY, 0)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, params):
    """Both ranks' results; the workers run while the JAX step compiles."""
    tmp = tmp_path_factory.mktemp("ranks")
    cases = dict(nc=NC, nano_dims=NANO, tiny_dims=TINY, nano=params["nano"], tiny=params["tiny"],
                 infer_cfg=INFER_CFG, sgd=SGD, infer_images=infer_images(),
                 train_batch=train_batch(), shards=[make_shard(r) for r in range(2)],
                 eval_argv=eval_argv(tmp, params["nano"]))
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    procs = run_ranks(tmp, WORKER)
    jax_step = _jax_dp_step(params["tiny"])
    wait_ranks(procs)
    res = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    return dict(tmp=tmp, res=res, jax=jax_step)


def _jax_dp_step(tiny):
    jm = JaxYOLO(*TINY, num_classes=NC)
    task = JaxTask(jm, **SGD)
    mesh = jax_make_mesh(jax.devices()[:2])
    p0 = jax.tree_util.tree_map(jnp.asarray, tiny)
    from yolort_tpu.trainer.task import TrainState as JaxState

    state = jax_replicate(mesh, JaxState(p0, task.tx.init(p0), jnp.zeros((), jnp.int32)))
    batch = [jax_shard_batch(mesh, jnp.asarray(a)) for a in train_batch()]
    state, metrics = jax_dp_step(task, mesh)(state, *batch)
    return to_numpy(state.params), {k: float(v) for k, v in metrics.items()}


def _single_step(tiny, batch):
    task = DefaultTask(port_model(TINY, tiny).trainable(), **SGD)
    state, metrics = task.train_step(TrainState(task.model, *task.make_optimizer()),
                                     *(torch.from_numpy(a) for a in batch))
    return params_to_jax(state.model), {k: float(v) for k, v in metrics.items()}


def _assert_tree_close(want, got, tol, what):
    worst = max(leaf_errors(want, got))
    assert worst[0] <= tol, f"{what}: worst leaf {worst[1]} at {worst[0]:.3g} (> {tol})"


# --- one process ------------------------------------------------------------

def test_the_collectives_are_the_identity_without_a_process_group():
    assert not torch.distributed.is_initialized()
    assert (D.get_world_size(), D.get_rank(), D.is_main_process()) == (1, 0, True)
    obj = {"a": np.arange(3)}
    assert D.all_gather_objects(obj) == [obj]
    assert D.all_reduce_mean(0.25) == 0.25
    from yolort_tpu_torch.utils.logger import SmoothedValue

    meter = SmoothedValue()
    meter.update(2.0)
    meter.synchronize_between_processes()
    assert (meter.total, meter.count) == (2.0, 1)
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()


def test_a_world_of_one_is_the_single_process_call(params):
    mesh = make_mesh(["cpu"])
    try:
        assert (mesh.world_size, mesh.data_size, mesh.model_size) == (1, 1, 1)
        assert torch.distributed.get_backend() == "gloo"
        model = port_model(NANO, params["nano"], **INFER_CFG)
        images = torch.from_numpy(infer_images())
        got = data_parallel_infer(replicate(mesh, model), mesh)(images)
        with torch.no_grad():
            want = model(images)
        assert int(want.num.min()) > 0
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        batch = train_batch()
        want_p, want_m = _single_step(params["tiny"], batch)
        task = DefaultTask(port_model(TINY, params["tiny"]).trainable(), **SGD)
        state = replicate(mesh, TrainState(task.model, *task.make_optimizer()))
        state, metrics = data_parallel_train_step(task, mesh)(
            state, *(torch.from_numpy(a) for a in batch))
        assert {k: float(v) for k, v in metrics.items()} == want_m
        _assert_tree_close(want_p, params_to_jax(state.model), 0.0, "world-1 step")
        assert make_mesh(["cpu"]).world_size == 1  # the group is up: reused
        with pytest.raises(ValueError, match="process group is up"):
            make_mesh(["cpu"], world_size=1)
        assert shard_batch(mesh, {"x": np.zeros((3, 2))})["x"].shape == (3, 2)
    finally:
        torch.distributed.destroy_process_group()


def test_a_world_of_one_issues_the_collectives(params, monkeypatch):
    """With a process group up, every collective is issued at world size 1
    too (so one card runs the NCCL calls many do): counted on gloo, each
    tensor handed to one contiguous, as NCCL requires (gloo does not), on
    a channels_last model as the card's is."""
    import torch.distributed as dist

    from yolort_tpu_torch.data.coco_eval import COCOEvaluator
    from yolort_tpu_torch.utils.logger import MetricLogger

    calls = {}
    for name in ("all_reduce", "all_gather", "broadcast", "all_gather_object"):
        def counted(*a, _fn=getattr(dist, name), _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            tensors = [a[0]] if isinstance(a[0], torch.Tensor) else [*a[0], a[1]]
            if _name != "all_gather_object":
                assert all(t.is_contiguous() for t in tensors), _name
            return _fn(*a, **kw)
        monkeypatch.setattr(dist, name, counted)
    mesh = make_mesh(["cpu"])
    try:
        model = port_model(NANO, params["nano"], **INFER_CFG)
        want = [t.clone() for t in model.state_dict().values()]
        model = replicate(mesh, model.to(memory_format=torch.channels_last))
        assert calls.pop("broadcast") == len([*model.parameters(), *model.buffers()])
        assert all(torch.equal(g, w) for g, w in zip(model.state_dict().values(), want))
        det = data_parallel_infer(model, mesh)(torch.from_numpy(infer_images()))
        assert calls.pop("all_gather") == len(det)
        task = DefaultTask(port_model(TINY, params["tiny"]).trainable(), **SGD)
        state = TrainState(task.model, *task.make_optimizer())
        data_parallel_train_step(task, mesh)(state, *(torch.from_numpy(a) for a in train_batch()))
        # the loss's candidate counts, the gradients (one dtype), the metrics
        assert calls.pop("all_reduce") == 3
        ev = COCOEvaluator()
        ev.update(*make_shard(0))
        ev.synchronize_between_processes()
        assert calls.pop("all_gather_object") == 1
        logger = MetricLogger()
        logger.update(loss=2.0)
        logger.synchronize_between_processes()
        assert calls.pop("all_reduce") == 1 and logger.loss.total == 2.0
        assert not calls
    finally:
        dist.destroy_process_group()


# --- two ranks ----------------------------------------------------------------

def test_two_ranks_know_their_place_and_reduce(ranks):
    for r, res in enumerate(ranks["res"]):
        assert (res["world"], res["rank"], res["main"]) == (2, r, r == 0)
        assert res["data"] == [2, r]
        assert res["mean"] == 0.5
        assert res["objects"] == [{"r": 0}, {"r": 1}]
        # each rank's total (4 and 6) averaged over the ranks
        assert res["meter_total"] == 5.0
        assert res["mesh2"] == [1, 2, 0, r]


def test_the_evaluator_merges_the_shards_of_both_ranks(ranks):
    from yolort_tpu_torch.data.coco_eval import COCOEvaluator

    ref = COCOEvaluator()
    for r in range(2):
        ref.update(*make_shard(r))
    want = ref.compute()
    for res in ranks["res"]:
        assert res["coco"].keys() == want.keys()
        for key, val in want.items():
            assert res["coco"][key] == pytest.approx(val, abs=1e-12), key


def test_data_parallel_infer_equals_the_single_process_call(ranks, params):
    model = port_model(NANO, params["nano"], **INFER_CFG)
    with torch.no_grad():
        want = model(torch.from_numpy(infer_images()))
    assert int(want.num.min()) > 0
    with np.load(ranks["tmp"] / "infer.npz") as got:
        for key, w in want._asdict().items():
            np.testing.assert_array_equal(got[key], w.numpy(), err_msg=key)


def test_data_parallel_train_step_is_the_global_batch_step(ranks, params):
    """Against the port's one-process step on the whole batch and JAX's
    ``data_parallel_train_step`` on a 2-device mesh; the halves' candidate
    counts differ, so averaging per-rank losses would not be this step."""
    from yolort_tpu_torch.models.losses import YOLOLoss

    images, targets, mask = train_batch()
    model = port_model(TINY, params["tiny"])
    loss = YOLOLoss(strides=model.strides, anchor_grids=model.anchor_grids, num_classes=NC)
    with torch.no_grad():
        outs = model.head_outputs(torch.from_numpy(images))
    halves = [[int(loss._candidates(o[h].shape, s, ag, torch.from_numpy(targets[h]),
                                    torch.from_numpy(mask[h]))["c_mask"].sum())
               for o, s, ag in zip(outs, model.strides, model.anchor_grids)]
              for h in (slice(0, 4), slice(4, 8))]
    assert sum(halves[0]) > 2 * sum(halves[1]) > 0, halves

    single_p, single_m = _single_step(params["tiny"], (images, targets, mask))
    jax_p, jax_m = ranks["jax"]
    got = [load_params(str(ranks["tmp"] / f"train{r}.npz"))[0] for r in range(2)]
    _assert_tree_close(got[0], got[1], 0.0, "rank 1 against rank 0")
    for res in ranks["res"]:
        assert res["step"] == 1
        for key in jax_m:
            np.testing.assert_allclose(res["metrics"][key], jax_m[key], rtol=1e-5, err_msg=key)
            np.testing.assert_allclose(res["metrics"][key], single_m[key], rtol=1e-5,
                                       err_msg=key)
    _assert_tree_close(jax_p, got[0], 1e-5, "params against JAX's data-parallel step")
    _assert_tree_close(single_p, got[0], 1e-5, "params against the one-process step")


def test_eval_metric_on_two_ranks_equals_one_process(ranks):
    """``tools/eval_metric --num_chips 2 --rank R --init_method file://...``:
    each rank loads the model onto its own device and serves its half of
    every batch; both ranks print the one-process metrics."""
    from yolort_tpu_torch.tools import eval_metric

    with open(ranks["tmp"] / "cases.pkl", "rb") as f:
        argv = pickle.load(f)["eval_argv"]
    want = eval_metric.cli_main(argv)
    assert want["AP50"] > 0
    for res in ranks["res"]:
        assert res["eval_metric"].keys() == want.keys()
        for key, w in want.items():
            np.testing.assert_equal(res["eval_metric"][key], w, err_msg=key)


def test_a_model_axis_of_two_steps_as_one_process(ranks, params):
    """(data 1, model 2): the model axis only replicates, as
    tests/test_parallel.py::test_2d_mesh_train_step has it."""
    want_p, want_m = _single_step(params["tiny"], tuple(a[:4] for a in train_batch()))
    for r, res in enumerate(ranks["res"]):
        assert res["metrics2"] == want_m
        got = load_params(str(ranks["tmp"] / f"model_axis{r}.npz"))[0]
        _assert_tree_close(want_p, got, 0.0, f"model-axis rank {r}")
