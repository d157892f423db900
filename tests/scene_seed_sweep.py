"""How the int8 AP harness's scene training depends on its init draw.

Trains the scene detector of ``utils/quant_probe.py`` for 1000 steps from
each seed and prints the last loss and the float AP, for the port (on the
CPU or the card, with or without deterministic algorithms) or for the JAX
package's own loop (``yolort_tpu.utils.quant_probe.train_scene_detector``
with ``jax.random.PRNGKey(seed)``, on the CPU):

    python tests/scene_seed_sweep.py torch --device cuda --seeds 0 1 2 3
    python tests/scene_seed_sweep.py torch --device cuda --seeds 0 0 2 2 --nondeterministic
    python tests/scene_seed_sweep.py jax --seeds 0 1 2 3 4 5

Run it from the repository root.  The torch mode imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
from unittest import mock

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def torch_runs(seeds, device: str, steps: int, nondeterministic: bool) -> None:
    import torch

    from yolort_tpu_torch.utils import quant_probe as QP

    images, gts = QP.make_scenes()
    where = device if device == "cpu" else torch.cuda.get_device_name(0)
    for seed in seeds:
        t0 = time.perf_counter()
        model = QP.scene_model(device).init_train(seed)
        # the harness trains deterministically; this lifts that for one run
        ctx = (mock.patch.object(QP, "deterministic", contextlib.nullcontext)
               if nondeterministic else contextlib.nullcontext())
        with ctx:
            loss = QP.train_scenes(model, images, gts, steps)
        model.requires_grad_(False)
        ap = QP.eval_ap(model, images, gts)
        print(f"torch {where} seed {seed} {'non' if nondeterministic else ''}deterministic: "
              f"{steps} steps, last loss {loss:.6f}, float AP {ap:.4f}, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


def jax_runs(seeds, steps: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import optax

    from yolort_tpu.models.losses import pad_targets
    from yolort_tpu.models.yolo import build_yolo
    from yolort_tpu.trainer import DefaultTask
    from yolort_tpu.utils import quant_probe as JP

    images, gts = JP.make_scenes()
    size = images.shape[1]
    model = build_yolo("yolov5_darknet_pan_n_r60", num_classes=2, score_thresh=0.1,
                       pre_nms_topk=256, nms_tile_size=64)
    per_image = [{"labels": g["labels"], "boxes_cxcywh_norm": np.asarray(
        [[(b[0] + b[2]) / 2 / size, (b[1] + b[3]) / 2 / size, (b[2] - b[0]) / size,
          (b[3] - b[1]) / size] for b in g["boxes"]])} for g in gts]
    targets, mask = pad_targets(per_image, 4)
    task = DefaultTask(model)
    tx = optax.adam(optax.cosine_decay_schedule(1e-3, steps, alpha=0.05))

    @jax.jit
    def step(params, opt_state):
        (total, _), grads = jax.value_and_grad(task.loss_fn, has_aux=True)(
            params, jnp.asarray(images), targets, mask)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, total

    for seed in seeds:
        t0 = time.perf_counter()
        params = model.init(jax.random.PRNGKey(seed))  # JAX's train_scene_detector loop
        opt_state = tx.init(params)
        for _ in range(steps):
            params, opt_state, total = step(params, opt_state)
        ap = JP.eval_ap(model, jax.device_get(params), images, gts)
        print(f"jax cpu PRNGKey({seed}): {steps} steps, last loss {float(total):.6f}, "
              f"float AP {ap:.4f}, {time.perf_counter() - t0:.1f} s", flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("framework", choices=("torch", "jax"))
    p.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    p.add_argument("--device", default="cuda", help="torch only: cuda or cpu")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--nondeterministic", action="store_true",
                   help="torch only: train without deterministic algorithms")
    a = p.parse_args(argv)
    if a.framework == "jax":
        jax_runs(a.seeds, a.steps)
    else:
        torch_runs(a.seeds, a.device, a.steps, a.nondeterministic)
    return 0


if __name__ == "__main__":
    sys.exit(main())
