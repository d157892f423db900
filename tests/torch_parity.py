"""Shared helpers of the parity tests between ``yolort_tpu`` (JAX) and
``yolort_tpu_torch`` (PyTorch): the same numpy inputs, made from a seed, go
through both.

The tiny model is r6.0 at depth 0.33 and width 0.125 (widths 8..128,
80 classes).  Its JAX params are given random BatchNorm statistics, and
every other conv is folded to the fused form, so both Conv param forms
cross the bridge.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from yolort_tpu.models.yolo import YOLO as JaxYOLO
from yolort_tpu.ops.blocks import StaticScale, fuse_conv_bn
from yolort_tpu_torch.models._bridge import params_from_jax
from yolort_tpu_torch.models.yolo import YOLO
from yolort_tpu_torch.ops.blocks import Bottleneck, Conv, Conv2dOnly

# the gate runs several xdist workers on few cores
torch.set_num_threads(1)

DEPTH, WIDTH = 0.33, 0.125


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def randomize_convs(params, seed: int = 0):
    """Random BatchNorm statistics on every unfused conv leaf, then every
    other such leaf folded to {'w', 'b'}; a standalone BatchNorm leaf (no
    'w') gets random statistics and stays unfused.  Returns a new numpy
    tree."""
    rng = np.random.default_rng(seed)
    count = [0]

    def walk(p):
        if isinstance(p, dict) and "gamma" in p:
            c = p["gamma"].shape[0]
            q = dict(
                gamma=rng.uniform(0.5, 1.5, c).astype(np.float32),
                beta=(rng.standard_normal(c) * 0.1).astype(np.float32),
                mean=(rng.standard_normal(c) * 0.1).astype(np.float32),
                var=rng.uniform(0.5, 1.5, c).astype(np.float32),
            )
            if "w" not in p:
                return q
            q["w"] = np.asarray(p["w"], np.float32)
            count[0] += 1
            if count[0] % 2:
                w, b = fuse_conv_bn(q["w"], q["gamma"], q["beta"], q["mean"], q["var"])
                return {"w": w, "b": b}
            return q
        if isinstance(p, dict):
            return {k: walk(v) for k, v in p.items()}
        return np.asarray(p)

    return walk(to_numpy(params))


def shift_head_bias(params, delta: float, num_anchors: int = 3):
    """Raise every head level's obj and class logits by ``delta`` so random
    weights produce candidates above the score thresholds."""
    out = dict(params)
    head = {}
    for key, leaf in params["head"].items():
        b = np.asarray(leaf["b"], np.float32).reshape(num_anchors, -1).copy()
        b[:, 4:] += delta
        head[key] = dict(leaf, b=b.reshape(-1))
    out["head"] = head
    return out


def tiny_pair(seed: int = 0, head_shift: float = 0.0, **kwargs):
    """(JAX YOLO, numpy params, port YOLO on the CPU) holding the same weights."""
    jm = JaxYOLO(DEPTH, WIDTH, **kwargs)
    params = randomize_convs(jm.init(jax.random.PRNGKey(seed)), seed)
    if head_shift:
        params = shift_head_bias(params, head_shift)
    tm = YOLO(DEPTH, WIDTH, device="cpu", **kwargs)
    params_from_jax(params, tm)
    return jm, params, tm


def nhwc_to_port(x: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the port's channels_last NCHW tensor."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def port_to_nhwc(y: torch.Tensor) -> np.ndarray:
    return y.permute(0, 2, 3, 1).detach().numpy()


def random_heads(seed: int, grids, batch: int = 2, nc: int = 80, na: int = 3,
                 shift: float = 0.0):
    """Per-level NHWC head logits; ``shift`` raises the obj/class logits."""
    rng = np.random.default_rng(seed)
    heads = []
    for h, w in grids:
        x = rng.standard_normal((batch, h, w, na, 5 + nc)).astype(np.float32) * 2.0
        x[..., 4:] += shift
        heads.append(x.reshape(batch, h, w, na * (5 + nc)))
    return heads


def unwrap_static(tree):
    """A finalized JAX int8 tree as numpy leaves and float scales."""
    if isinstance(tree, dict):
        return {k: unwrap_static(v) for k, v in tree.items()}
    if isinstance(tree, StaticScale):
        return tree.v
    return np.asarray(tree)


MARKS = ("_absmax", "_out_absmax", "_add_absmax")


def copy_marks(tree, module):
    """Put the calibration marks of a calibrated JAX tree on the port's
    modules (the bridge carries weights, not marks)."""
    for key in MARKS:
        if key in tree:
            setattr(module, key, float(tree[key]))
    if isinstance(module, (Conv, Conv2dOnly)):
        return
    for key, sub in tree.items():
        if isinstance(sub, dict):
            copy_marks(sub, module._modules[key])


def port_int8_leaf(module) -> dict:
    """A quantized port conv as {'wq' packed (Cout, Kpad), 'ws', 'xs'[, 'os'],
    'b'} (the port always holds a bias, zeros if the conv had none)."""
    leaf = {"wq": module.wq.numpy(), "ws": module.ws_bits.view(torch.float32).numpy(),
            "xs": module.xs, "b": module.b_bits.view(torch.float32).numpy()}
    if module.os is not None:
        leaf["os"] = module.os
    return leaf


def walk_convs(tree, module, path=()):
    """(path, JAX node, port module) for every conv leaf and Bottleneck of
    a JAX tree and the port module holding it."""
    if isinstance(module, (Conv, Conv2dOnly)):
        yield path, tree, module
        return
    if isinstance(module, Bottleneck):
        yield path, tree, module
    for key, sub in tree.items():
        if isinstance(sub, dict):
            yield from walk_convs(sub, module._modules[key], path + (key,))


def walk_convs_paths(tree, path=()):
    """('/'-joined path, node, None) of every conv leaf of a JAX tree (a dict
    with a 4-d 'w', a weight-only quantized 'w' {'q', 'scale'} or a 'wq'),
    in the tree's own key order."""
    w = tree.get("w")
    if "wq" in tree or (isinstance(w, dict) and "q" in w) or np.ndim(w) == 4:
        yield "/".join(path), tree, None
        return
    for key, sub in tree.items():
        if isinstance(sub, dict):
            yield from walk_convs_paths(sub, path + (key,))


def leaf_errors(want, got, path=""):
    """(error relative to the leaf's largest |want|, path) of every leaf of
    two numpy trees with the same keys; raises on a key or shape mismatch."""
    assert set(want) == set(got), (path, sorted(want), sorted(got))
    out = []
    for key in want:
        a, b = want[key], got[key]
        if isinstance(a, dict):
            out += leaf_errors(a, b, f"{path}/{key}")
            continue
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (f"{path}/{key}", a.shape, b.shape)
        scale = float(np.abs(a).max()) if a.size else 0.0
        err = float(np.abs(a - b).max()) if a.size else 0.0
        out.append((err / scale if scale else err, f"{path}/{key}"))
    return out


def random_targets(seed: int, batch: int = 2, t: int = 4, nc: int = 8, valid=(3, 2)):
    """(targets (B, T, 5) [cls, cx, cy, w, h] normalised, mask (B, T)) as
    numpy: the first ``valid[i]`` rows of image i are real."""
    rng = np.random.default_rng(seed)
    tg = np.zeros((batch, t, 5), np.float32)
    tg[..., 0] = rng.integers(0, nc, (batch, t))
    tg[..., 1:3] = rng.uniform(0.1, 0.9, (batch, t, 2))
    tg[..., 3:5] = rng.uniform(0.05, 0.5, (batch, t, 2))
    mask = np.arange(t)[None, :] < np.asarray(valid)[:, None]
    return tg, mask
