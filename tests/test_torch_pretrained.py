"""``pretrained=True`` in the port against the JAX package's
``load_pretrained_params`` (``yolort_tpu/models/_checkpoint.py``), on the
CPU, with a fabricated yolov5n checkpoint (``torch_fixture.make_checkpoint``,
80 classes) in a temporary weights directory.

- From ``<arch>_coco.pt`` and from the ``.npz`` the port's converter writes
  of it, and from the registry's sha-suffixed name: every parameter of
  ``yolov5n(pretrained=True, device="cpu")`` bit-equal to the JAX tree
  (float32; bfloat16 is the float32 tree rounded, as ``dtype=`` asks).
- The lookup order (``.npz`` before ``.pt``, ``$YOLORT_TPU_WEIGHTS`` before
  ``~/.cache/yolort_tpu``), a sha mismatch (``ValueError``) and a missing
  file (``FileNotFoundError``, JAX's message) as in JAX.
- With ``YOLORT_HUB_BASE`` on a loopback server: only the registry's
  ``.pt`` is requested, its hash checked (a tampered asset raises); cases
  of tests/test_downloads.py.
- The hub file's entries pass ``pretrained`` on.
"""

import hashlib
import http.server
import threading
from contextlib import contextmanager
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from torch_fixture import make_checkpoint
from yolort_tpu.models import _checkpoint as JC
from yolort_tpu.utils import robustness as JR
from yolort_tpu_torch import YOLOv5, yolov5n
from yolort_tpu_torch.models._bridge import params_to_jax
from yolort_tpu_torch.models._checkpoint import convert_yolov5_checkpoint, load_pretrained_params
from yolort_tpu_torch.utils import robustness as R

ARCH = "yolov5_darknet_pan_n_r60"
ROOT = Path(__file__).resolve().parent.parent


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def assert_same_tree(got, want):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w) and len(g) > 100
    for k in w:
        assert g[k].shape == w[k].shape, k
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """(path, bytes) of a fabricated yolov5n checkpoint, 80 classes."""
    path = tmp_path_factory.mktemp("ckpt") / "src.pt"
    make_checkpoint(str(path), nc=80, dm=0.33, wm=0.25, seed=5)
    return path, path.read_bytes()


@pytest.fixture
def weights_dir(tmp_path, monkeypatch):
    """An empty weights directory as $YOLORT_TPU_WEIGHTS, an empty home (so
    ~/.cache/yolort_tpu holds nothing) and no hub."""
    wd = tmp_path / "weights"
    wd.mkdir()
    monkeypatch.setenv("YOLORT_TPU_WEIGHTS", str(wd))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("YOLORT_HUB_BASE", raising=False)
    return wd


def both_registries(monkeypatch, name):
    for reg in (R.PRETRAINED_REGISTRY, JR.PRETRAINED_REGISTRY):
        monkeypatch.setitem(reg, ARCH, name)


@pytest.mark.parametrize("form", ["pt", "npz"])
def test_pretrained_params_equal_jax(weights_dir, checkpoint, form):
    src, blob = checkpoint
    if form == "pt":
        (weights_dir / f"{ARCH}_coco.pt").write_bytes(blob)
    else:
        out = convert_yolov5_checkpoint(str(src), str(weights_dir), postfix="coco.npz")
        assert Path(out).name == f"{ARCH}_coco.npz"
    want = JC.load_pretrained_params(ARCH, None)
    assert_same_tree(load_pretrained_params(ARCH), want)
    m = yolov5n(pretrained=True, device="cpu")
    assert_same_tree(params_to_jax(m.model), want)
    # dtype= is honoured: the same weights rounded to bfloat16
    mb = yolov5n(pretrained=True, device="cpu", dtype=torch.bfloat16)
    for (n, p), (nb, pb) in zip(m.model.named_parameters(), mb.model.named_parameters()):
        assert n == nb and pb.dtype == torch.bfloat16
        assert torch.equal(pb, p.to(torch.bfloat16)), n


def test_registry_name_and_lookup_order(weights_dir, checkpoint, monkeypatch, tmp_path):
    src, blob = checkpoint
    sha8 = hashlib.sha256(blob).hexdigest()[:8]
    both_registries(monkeypatch, f"{ARCH}_coco-{sha8}")
    (weights_dir / f"{ARCH}_coco-{sha8}.pt").write_bytes(blob)
    want = JC.load_pretrained_params(ARCH, None)
    assert_same_tree(load_pretrained_params(ARCH), want)
    # an .npz of other weights under the plain name comes first, in both
    other = tmp_path / "other.pt"
    make_checkpoint(str(other), nc=80, dm=0.33, wm=0.25, seed=6)
    convert_yolov5_checkpoint(str(other), str(weights_dir), postfix="coco.npz")
    want2 = JC.load_pretrained_params(ARCH, None)
    assert_same_tree(load_pretrained_params(ARCH), want2)
    assert not np.array_equal(flat(want2)["/head/0/w"], flat(want)["/head/0/w"])
    # ~/.cache/yolort_tpu is read where $YOLORT_TPU_WEIGHTS has nothing
    monkeypatch.setenv("YOLORT_TPU_WEIGHTS", str(tmp_path / "empty"))
    cache = tmp_path / "home" / ".cache" / "yolort_tpu"
    cache.mkdir(parents=True)
    (cache / f"{ARCH}_coco.pt").write_bytes(blob)
    assert_same_tree(load_pretrained_params(ARCH), JC.load_pretrained_params(ARCH, None))
    assert_same_tree(load_pretrained_params(ARCH), want)


def test_sha_mismatch_raises_as_in_jax(weights_dir, checkpoint, monkeypatch):
    _, blob = checkpoint
    both_registries(monkeypatch, f"{ARCH}_coco-deadbeef")
    (weights_dir / f"{ARCH}_coco-deadbeef.pt").write_bytes(blob)
    with pytest.raises(ValueError, match="sha256 mismatch") as jax_err:
        JC.load_pretrained_params(ARCH, None)
    with pytest.raises(ValueError, match="sha256 mismatch") as err:
        yolov5n(pretrained=True, device="cpu")
    assert str(err.value) == str(jax_err.value)


def test_missing_weights_raise_jax_message(weights_dir):
    with pytest.raises(FileNotFoundError) as jax_err:
        JC.load_pretrained_params(ARCH, None)
    with pytest.raises(FileNotFoundError) as err:
        yolov5n(pretrained=True, device="cpu")
    assert str(err.value) == str(jax_err.value) and "No pretrained weights" in str(err.value)
    with pytest.raises(ValueError, match="keeps its own"):
        YOLOv5(model=yolov5n(device="cpu").model, pretrained=True)


def test_hub_entry_passes_pretrained_on(weights_dir, checkpoint):
    _, blob = checkpoint
    (weights_dir / f"{ARCH}_coco.pt").write_bytes(blob)
    m = torch.hub.load(str(ROOT / "yolort_tpu_torch"), "yolov5n", source="local",
                       pretrained=True, device="cpu", score_thresh=0.3)
    assert isinstance(m, YOLOv5) and m.model.score_thresh == 0.3
    assert_same_tree(params_to_jax(m.model), JC.load_pretrained_params(ARCH, None))


@contextmanager
def serve(handler_cls):
    with http.server.HTTPServer(("127.0.0.1", 0), handler_cls) as srv:
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            yield f"http://127.0.0.1:{srv.server_port}"
        finally:
            srv.shutdown()
            t.join(10)
            assert not t.is_alive()


def hub_handler(routes: dict, requested: list):
    class Hub(http.server.BaseHTTPRequestHandler):
        timeout = 10.0  # the server's socket timeout: no case hangs

        def do_GET(self):
            requested.append(self.path)
            body = next((b for suffix, b in routes.items() if self.path.endswith(suffix)), None)
            if body is None:
                self.send_error(404)
                return
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    return Hub


def test_download_fetches_only_the_registry_pt(weights_dir, checkpoint, monkeypatch):
    """With no local file and a hub configured, only the registry's
    sha-suffixed .pt is requested, verified, cached in the weights
    directory and loaded."""
    _, blob = checkpoint
    reg_name = f"{ARCH}_coco-{hashlib.sha256(blob).hexdigest()[:8]}"
    both_registries(monkeypatch, reg_name)
    requested = []
    with serve(hub_handler({f"{reg_name}.pt": blob}, requested)) as base:
        monkeypatch.setenv("YOLORT_HUB_BASE", base)
        m = yolov5n(pretrained=True, device="cpu")
    assert requested == [f"/{reg_name}.pt"]
    assert (weights_dir / f"{reg_name}.pt").read_bytes() == blob
    want = JC.load_from_ultralytics(str(weights_dir / f"{reg_name}.pt"))["params"]
    assert_same_tree(params_to_jax(m.model), want)
    # the cached file is read without the hub
    monkeypatch.delenv("YOLORT_HUB_BASE")
    assert_same_tree(load_pretrained_params(ARCH), want)


def test_hub_sha_tamper_raises_without_fallthrough(weights_dir, monkeypatch):
    reg_name = f"{ARCH}_coco-deadbeef"
    both_registries(monkeypatch, reg_name)
    evil = b"not the weights that were published" * 64
    requested = []
    with serve(hub_handler({".pt": evil, ".npz": evil}, requested)) as base:
        monkeypatch.setenv("YOLORT_HUB_BASE", base)
        with pytest.raises(ValueError, match="sha256 mismatch"):
            load_pretrained_params(ARCH)
    assert requested and all(p == f"/{reg_name}.pt" for p in requested)
    assert not any(weights_dir.iterdir())  # nothing poisoned is left to load


def test_no_hub_for_an_arch_outside_the_registry(weights_dir, monkeypatch):
    requested = []
    with serve(hub_handler({}, requested)) as base:
        monkeypatch.setenv("YOLORT_HUB_BASE", base)
        with pytest.raises(FileNotFoundError):
            load_pretrained_params("yolov5_darknet_pan_x_r60")
    assert requested == []


def test_jax_params_are_numpy_leaves(checkpoint, weights_dir):
    """The port's tree has numpy leaves as the bridge takes them; the JAX
    tree's are jax arrays of the same values."""
    _, blob = checkpoint
    (weights_dir / f"{ARCH}_coco.pt").write_bytes(blob)
    got = load_pretrained_params(ARCH)
    assert all(isinstance(v, np.ndarray) for v in flat(got).values())
    leaves = jax.tree_util.tree_leaves(JC.load_pretrained_params(ARCH, None))
    assert len(leaves) == len(flat(got))
