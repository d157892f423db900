"""``fit`` and ``evaluate`` of the port over a two-rank gloo mesh on the CPU
(mirrors tests/test_fit_mesh.py), each rank a subprocess of its own
(tests/test_torch_parallel.py's ``run_ranks``), on seeded synthetic COCO
sets (``data._helper.create_synthetic_coco``) at 96x96:

- ``evaluate(..., mesh=)`` equals ``evaluate`` in one process on 8 images,
  and on 11 (a final batch of 3, padded to 4; padded rows never read), at
  the JAX test's rtol 1e-6 / atol 1e-7;
- ``fit(..., mesh=)`` over 11 images at batch 8 takes one step (the batch
  of 3 does not divide the data axis and is dropped) with its validation
  on the mesh; both ranks end with the same parameters, which match
  ``fit`` in one process over the same data with ``drop_last`` within
  1e-5 relative to each leaf's largest |value| (the gradient sum's order);
  rank 0 alone writes the checkpoint.
"""

import json
import pickle
import textwrap

import jax
import numpy as np
import pytest
from test_torch_parallel import run_ranks, wait_ranks
from torch_parity import leaf_errors, randomize_convs
from yolort_tpu.models.yolo import YOLO as JaxYOLO
from yolort_tpu_torch.data._helper import create_synthetic_coco
from yolort_tpu_torch.data.coco import COCODetection
from yolort_tpu_torch.data.data_module import DetectionDataModule
from yolort_tpu_torch.models._bridge import params_from_jax, params_to_jax
from yolort_tpu_torch.models._checkpoint import load_params
from yolort_tpu_torch.models.yolo import YOLO
from yolort_tpu_torch.trainer.fit import evaluate, fit
from yolort_tpu_torch.trainer.task import DefaultTask

DIMS = (0.33, 0.125)
NC = 3
HW = (96, 96)
MODEL_CFG = dict(score_thresh=1e-4, pre_nms_topk=256, nms_tile_size=64)

WORKER = textwrap.dedent("""
    import json, os, pickle, sys
    sys.path.insert(0, os.environ["REPO"])
    import torch
    torch.set_num_threads(1)
    from yolort_tpu_torch.data.coco import COCODetection
    from yolort_tpu_torch.data.data_module import DetectionDataModule
    from yolort_tpu_torch.models._bridge import params_from_jax
    from yolort_tpu_torch.models._checkpoint import save_params
    from yolort_tpu_torch.models._bridge import params_to_jax
    from yolort_tpu_torch.models.yolo import YOLO
    from yolort_tpu_torch.parallel import make_mesh
    from yolort_tpu_torch.trainer.fit import evaluate, fit
    from yolort_tpu_torch.trainer.task import DefaultTask

    rank, out = int(os.environ["RANK"]), os.environ["OUT"]
    with open(os.path.join(out, "cases.pkl"), "rb") as f:
        c = pickle.load(f)

    def model():
        return params_from_jax(c["params"], YOLO(*c["dims"], device="cpu",
                                                 num_classes=c["nc"], **c["cfg"]))

    def dm(name, **kw):
        ds = COCODetection(*c["sets"][name])
        return DetectionDataModule(ds, batch_size=8, canvas_hw=c["hw"], min_size=c["hw"][0],
                                   max_size=c["hw"][0], **kw)

    mesh = make_mesh(["cpu", "cpu"], init_method=os.environ["INIT"], world_size=2, rank=rank)
    res = {name: evaluate(model(), dm(name), c["hw"], mesh=mesh) for name in ("eight", "eleven")}
    task = DefaultTask(model(), lr=0.01)
    state = fit(task, dm("eleven"), val_data=dm("eleven"), max_epochs=1, mesh=mesh,
                print_freq=1000, state=task.init_state(0),
                checkpoint_path=os.path.join(out, f"ckpt{rank}.npz"))
    res["step"] = state.step
    save_params(os.path.join(out, f"fit{rank}.npz"), params_to_jax(state.model))
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
""")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit_mesh")
    sets = {}
    for name, n, seed in (("eight", 8, 0), ("eleven", 11, 1)):
        img_dir, ann = create_synthetic_coco(tmp / name, num_images=n, num_classes=NC, seed=seed,
                                             image_hw=HW)
        sets[name] = (str(img_dir), str(ann))
    jm = JaxYOLO(*DIMS, num_classes=NC)
    params = randomize_convs(jm.init(jax.random.PRNGKey(0)), 0)
    cases = dict(params=params, dims=DIMS, nc=NC, cfg=MODEL_CFG, hw=HW, sets=sets)
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump(cases, f)
    wait_ranks(run_ranks(tmp, WORKER))
    res = [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(2)]
    return dict(tmp=tmp, res=res, cases=cases)


def _model(cases):
    return params_from_jax(cases["params"], YOLO(*DIMS, device="cpu", num_classes=NC,
                                                 **MODEL_CFG))


def _dm(cases, name, **kw):
    return DetectionDataModule(COCODetection(*cases["sets"][name]), batch_size=8, canvas_hw=HW,
                               min_size=HW[0], max_size=HW[0], **kw)


@pytest.mark.parametrize("name", ["eight", "eleven"])
def test_evaluate_on_a_mesh_equals_one_process(setup, name):
    single = evaluate(_model(setup["cases"]), _dm(setup["cases"], name), HW)
    assert np.isfinite(single["AP50"])
    for res in setup["res"]:
        sharded = res[name]
        assert set(sharded) == set(single)
        for k in single:
            np.testing.assert_allclose(sharded[k], single[k], rtol=1e-6, atol=1e-7, err_msg=k)


def test_fit_on_a_mesh_is_the_one_process_fit(setup):
    cases = setup["cases"]
    got = [load_params(str(setup["tmp"] / f"fit{r}.npz"))[0] for r in range(2)]
    assert [res["step"] for res in setup["res"]] == [1, 1]
    worst = max(leaf_errors(got[0], got[1]))
    assert worst[0] == 0.0, worst
    task = DefaultTask(_model(cases), lr=0.01)
    state = fit(task, _dm(cases, "eleven", drop_last=True), val_data=None, max_epochs=1,
                print_freq=1000, state=task.init_state(0))
    assert state.step == 1
    want = params_to_jax(state.model)
    worst = max(leaf_errors(want, got[0]))
    assert worst[0] <= 1e-5, worst
    assert all(np.isfinite(v).all() for v in _leaves(got[0]))
    assert (setup["tmp"] / "ckpt0.npz").exists() and not (setup["tmp"] / "ckpt1.npz").exists()


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
