"""Checkpoint ingestion: an ultralytics/yolov5 ``.pt`` -> the JAX-layout
params tree with numpy leaves, which ``models/_bridge.params_from_jax``
loads into the port.

Port of ``yolort_tpu/models/_checkpoint.py`` (torch and numpy only):

  * the pickle is loaded with a stub unpickler that turns every class it
    cannot import into a plain state holder, and the module tree is walked
    through its ``_modules`` / ``_parameters`` / ``_buffers`` dicts, so no
    ultralytics code is needed;
  * weights go OIHW -> HWIO as float32 (half checkpoints are cast to float
    first) and every Conv's BatchNorm is folded into it in float64
    (``ops.blocks.fuse_conv_bn``), so the leaves are bit-equal to the JAX
    package's; BottleneckCSP's standalone BatchNorm stays unfused.  With
    ``fuse=False`` each Conv keeps ``w``, ``gamma``, ``beta``, ``mean`` and
    ``var``: the train form a fine-tuning run starts from;
  * the flat ``model.N`` indices map onto the structured tree by the P5
    and P6 index tables.

The TAN variant (ultralytics v5.0 ``yolov5s-transformer.yaml``) is the
r4.0 layout with a ``C3TR`` at flat layer 9: ``load_from_ultralytics``
reports it as ``use_tan``, from that layer's pickled class name, and the
checkpoint loads as r4.0.  ``save_params`` /
``load_params`` write and read the JAX package's ``.npz`` layout, so a
file written by either package loads in the other.  ``load_pretrained_params``
finds an arch's COCO weights in a local weights directory, as the JAX
package does, so one directory serves both packages.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from yolort_tpu_torch.models.darknet import VERSIONS
from yolort_tpu_torch.ops.blocks import fuse_conv_bn

__all__ = ["load_from_ultralytics", "convert_yolov5_checkpoint", "save_params", "load_params",
           "get_yolov5_size", "load_pretrained_params", "weights_dirs"]


# --- stub unpickling of ultralytics checkpoints ---------------------------

class _Stub:
    """Any pickled class that cannot be imported, as a plain state holder."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state

    def __getattr__(self, name):
        d = object.__getattribute__(self, "__dict__")
        for container in ("_modules", "_parameters", "_buffers"):
            sub = d.get(container)
            if sub is not None and name in sub:
                return sub[name]
        raise AttributeError(name)


_STUB_CACHE: Dict[Tuple[str, str], type] = {}


def _stub_class(module: str, name: str) -> type:
    key = (module, name)
    if key not in _STUB_CACHE:
        _STUB_CACHE[key] = type(name, (_Stub,), {"__module__": module})
    return _STUB_CACHE[key]


class _StubUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        # torch's own classes resolve, so tensors rebuild; anything else
        # (ultralytics 'models.*', 'utils.*', ...) may become a stub
        try:
            return super().find_class(module, name)
        except (ImportError, AttributeError):
            return _stub_class(module, name)


class _PickleModule:
    """The ``pickle_module`` torch.load takes: its Unpickler is the stub one."""

    Unpickler = _StubUnpickler
    loads = staticmethod(pickle.loads)

    @staticmethod
    def load(f, **kw):
        return _StubUnpickler(f).load()


def load_torch_checkpoint(path: str) -> Any:
    """``torch.load`` with stub classes for the ultralytics module tree.  A
    pickled module tree needs ``weights_only=False`` (torch >= 2.6 defaults
    to True): it runs the pickle, so load only checkpoints you trust."""
    import torch

    return torch.load(path, map_location="cpu", pickle_module=_PickleModule, weights_only=False)


# --- walking an nn.Module tree (real modules and stubs alike) ------------

def _dict_of(m, key):
    return object.__getattribute__(m, "__dict__").get(key) or {}


def _children(m) -> Dict[str, Any]:
    return dict(_dict_of(m, "_modules"))


def _params_of(m) -> Dict[str, Any]:
    return {k: v for k, v in _dict_of(m, "_parameters").items() if v is not None}


def _buffers_of(m) -> Dict[str, Any]:
    return {k: v for k, v in _dict_of(m, "_buffers").items() if v is not None}


def _np(t) -> np.ndarray:
    arr = t.detach().cpu().float().numpy() if hasattr(t, "detach") else np.asarray(t)
    return np.ascontiguousarray(arr.astype(np.float32))


def _cls_name(m) -> str:
    return type(m).__name__


def _seq_children(m) -> List[Any]:
    """Children of a Sequential / ModuleList (or its stub) in index order."""
    return [v for _, v in sorted(_children(m).items(), key=lambda kv: int(kv[0]))]


# --- leaf converters (torch layouts -> the JAX tree's) --------------------

def _convert_conv2d(m) -> Dict[str, np.ndarray]:
    p = _params_of(m)
    out = {"w": _np(p["weight"]).transpose(2, 3, 1, 0)}  # OIHW -> HWIO
    if "bias" in p:
        out["b"] = _np(p["bias"])
    return out


def _convert_conv_bn(m, fuse: bool = True) -> Dict[str, np.ndarray]:
    """An ultralytics Conv: conv (Conv2d, no bias) + bn + act, folded unless
    ``fuse`` is False."""
    ch = _children(m)
    w = _np(_params_of(ch["conv"])["weight"]).transpose(2, 3, 1, 0)
    bn = _convert_batchnorm(ch["bn"])
    if not fuse:
        return {"w": w, **bn}
    eps = float(object.__getattribute__(ch["bn"], "__dict__").get("eps", 1e-3))
    w_f, b_f = fuse_conv_bn(w, bn["gamma"], bn["beta"], bn["mean"], bn["var"], eps=eps)
    return {"w": w_f, "b": b_f}


def _convert_batchnorm(m) -> Dict[str, np.ndarray]:
    p, b = _params_of(m), _buffers_of(m)
    return {"gamma": _np(p["weight"]), "beta": _np(p["bias"]),
            "mean": _np(b["running_mean"]), "var": _np(b["running_var"])}


def _convert_linear(m) -> Dict[str, np.ndarray]:
    p = _params_of(m)
    out = {"w": _np(p["weight"]).T}  # (out, in) -> (in, out)
    if "bias" in p:
        out["b"] = _np(p["bias"])
    return out


def _convert_mha(m) -> Dict[str, Any]:
    """torch.nn.MultiheadAttention -> {'in_proj_w', 'in_proj_b', 'out_proj'}."""
    p = _params_of(m)
    return {"in_proj_w": _np(p["in_proj_weight"]), "in_proj_b": _np(p["in_proj_bias"]),
            "out_proj": _convert_linear(_children(m)["out_proj"])}


_PARAMFREE = {"SiLU", "Hardswish", "LeakyReLU", "Identity", "Upsample", "MaxPool2d", "Concat",
              "Dropout", "ReLU", "ReLU6"}


def convert_module(m, fuse: bool = True) -> Optional[Dict[str, Any]]:
    """Convert any (stub) module subtree into the params tree, each Conv's
    BatchNorm folded unless ``fuse`` is False.  The child names of
    ultralytics blocks (cv1, cv2, m, 0, 1, ...) are the tree's keys, so the
    walk is generic."""
    name = _cls_name(m)
    ch = _children(m)
    if name == "Conv2d":
        return _convert_conv2d(m)
    if name == "BatchNorm2d":
        return _convert_batchnorm(m)
    if name == "Linear":
        return _convert_linear(m)
    if name == "MultiheadAttention":
        return _convert_mha(m)
    if name in _PARAMFREE and not ch:
        return None
    if "conv" in ch and "bn" in ch and _cls_name(ch["conv"]) == "Conv2d":
        return _convert_conv_bn(m, fuse)
    out: Dict[str, Any] = {}
    for k, sub in ch.items():
        if _cls_name(sub) == "MultiheadAttention" and k == "ma":
            out.update(_convert_mha(sub))  # flattened into the TransformerLayer
            continue
        converted = convert_module(sub, fuse)
        if converted is not None:
            out[k] = converted
    for k, v in _params_of(m).items():
        out.setdefault(k, _np(v))
    return out or None


# --- flat index -> structured tree -----------------------------------------

P5_INNER_MAP = {"0": 9, "1": 10, "3": 13, "4": 14}
P5_LAYER_MAP = {"0": 17, "1": 18, "2": 20, "3": 21, "4": 23}

P6_P6_MAP = {"0": 9, "1": 10}
P6_INNER_MAP = {"0": 11, "1": 12, "3": 15, "4": 16, "6": 19, "7": 20}
P6_LAYER_MAP = {"0": 23, "1": 24, "2": 26, "3": 27, "4": 29, "5": 30, "6": 32}

# the flat layer that is a C3TR in the TAN variant (the PAN's first inner block)
TAN_LAYER = 9


def get_yolov5_size(depth_multiple: float, width_multiple: float) -> str:
    table = {(0.33, 0.25): "n", (0.33, 0.5): "s", (0.67, 0.75): "m", (1.0, 1.0): "l",
             (1.33, 1.25): "x"}
    key = (round(depth_multiple, 2), round(width_multiple, 2))
    if key not in table:
        raise NotImplementedError(f"Unsupported depth/width multiples ({depth_multiple}, "
                                  f"{width_multiple})")
    return table[key]


def load_from_ultralytics(checkpoint_path: str, version: str = "r6.0", fuse: bool = True
                          ) -> Dict:
    """An ultralytics ``.pt`` as {'num_classes', 'depth_multiple',
    'width_multiple', 'strides', 'anchor_grids', 'use_p6', 'size',
    'params'}: the JAX package's metadata, and its params tree with numpy
    leaves (each Conv unfused when ``fuse`` is False); and 'use_tan',
    whether flat layer 9 is a ``C3TR`` (the TAN variant)."""
    if version not in VERSIONS:
        raise NotImplementedError(f"Unsupported version {version}")
    ckpt = load_torch_checkpoint(checkpoint_path)
    model = (ckpt.get("ema") or ckpt["model"]) if isinstance(ckpt, dict) else ckpt  # EMA first

    yaml_cfg = object.__getattribute__(model, "__dict__").get("yaml", {})
    depth_multiple = float(yaml_cfg["depth_multiple"])
    width_multiple = float(yaml_cfg["width_multiple"])

    flat = _seq_children(_children(model)["model"])
    detect = flat[-1]
    det_buf = _buffers_of(detect)
    # 'stride' is a Detect buffer, a Detect attribute or a model attribute,
    # by ultralytics version
    stride_t = next(c for c in (det_buf.get("stride"),
                                object.__getattribute__(detect, "__dict__").get("stride"),
                                object.__getattribute__(model, "__dict__").get("stride"))
                    if c is not None)
    strides = [int(s) for s in _np(stride_t).reshape(-1).tolist()]
    use_p6 = len(strides) == 4
    # the anchors of the Detect buffers (autoanchor may have changed the yaml's)
    anchors = _np(det_buf["anchors"])  # (nl, na, 2), in strides
    anchor_grids = (anchors * np.asarray(strides, np.float32)[:, None, None]).reshape(
        len(strides), -1).tolist()

    inner_map, layer_map, p6_map = ((P6_INNER_MAP, P6_LAYER_MAP, P6_P6_MAP) if use_p6
                                    else (P5_INNER_MAP, P5_LAYER_MAP, None))
    backbone = {str(i): convert_module(flat[i], fuse) for i in range(9)}
    pan: Dict[str, Any] = {
        "inner": {k: convert_module(flat[i], fuse) for k, i in inner_map.items()},
        "layer": {k: convert_module(flat[i], fuse) for k, i in layer_map.items()},
    }
    if p6_map is not None:
        pan["p6"] = {k: convert_module(flat[i], fuse) for k, i in p6_map.items()}
    head = {str(i): _convert_conv2d(c) for i, c in enumerate(_seq_children(_children(detect)["m"]))}
    return {
        "num_classes": int(yaml_cfg["nc"]),
        "depth_multiple": depth_multiple,
        "width_multiple": width_multiple,
        "strides": strides,
        "anchor_grids": anchor_grids,
        "use_p6": use_p6,
        "use_tan": _cls_name(flat[TAN_LAYER]) == "C3TR",
        "size": get_yolov5_size(depth_multiple, width_multiple),
        "params": {"backbone": backbone, "pan": pan, "head": head},
    }


# --- the .npz format: leaves under '/'-joined keys, meta as JSON bytes ----

def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def convert_yolov5_checkpoint(checkpoint_path: str, output_path: str, version: str = "r6.0",
                              prefix: str = "yolov5_darknet_pan",
                              postfix: str = "custom.npz") -> str:
    """Convert an ultralytics ``.pt`` into a ``save_params`` file under the
    directory ``output_path``, named as the JAX package names it
    (``<prefix>_<size>[6]_<version>_<postfix>``), its metadata in
    ``__meta__``.  Returns the file's path."""
    info = load_from_ultralytics(checkpoint_path, version=version)
    p6 = "6" if info["use_p6"] else ""
    name = f"{prefix}_{info['size']}{p6}_{version.replace('.', '')}_{postfix}"
    out = str(Path(output_path) / name)
    meta = {k: info[k] for k in ("num_classes", "depth_multiple", "width_multiple", "strides",
                                 "anchor_grids", "use_p6", "size")}
    save_params(out, info["params"], meta)
    return out


def save_params(path: str, params, meta: Optional[Dict] = None) -> None:
    flat = _flatten(params)
    flat["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def load_params(path: str) -> Tuple[Dict, Dict]:
    """(params tree with numpy leaves, meta) of a ``save_params`` file."""
    data = np.load(path, allow_pickle=False)
    tree: Dict[str, Any] = {}
    meta: Dict = {}
    for key in data.files:
        if key == "__meta__":
            meta = json.loads(bytes(data[key]).decode())
            continue
        node = tree
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = data[key]
    return tree, meta


# --- pretrained weights ---------------------------------------------------

def weights_dirs() -> List[str]:
    """The local weights directories, in lookup order: ``$YOLORT_TPU_WEIGHTS``
    (where set), then ``~/.cache/yolort_tpu``."""
    import os

    roots = [os.environ.get("YOLORT_TPU_WEIGHTS", ""), os.path.expanduser("~/.cache/yolort_tpu")]
    return [r for r in roots if r]


def load_pretrained_params(arch: str) -> Dict[str, Any]:
    """The JAX-layout params tree (numpy leaves) of ``arch``'s COCO weights,
    the JAX package's lookup: in each weights directory (``weights_dirs``),
    ``<arch>_coco`` then the registry's sha-suffixed name, each as ``.npz``
    (``save_params``' layout, which both packages write) before ``.pt``
    (an ultralytics checkpoint, read as r6.0).  A file whose name carries a
    sha256 prefix must match it (else ``ValueError``).  Where no file is
    found and ``YOLORT_HUB_BASE`` names a hub, only the registry's ``.pt``
    is downloaded into the first weights directory, its hash passed
    explicitly, so an unverified pickle never reaches ``torch.load``.
    Else ``FileNotFoundError``."""
    from yolort_tpu_torch.utils.robustness import (
        PRETRAINED_REGISTRY, attempt_download, hub_base, verify_checkpoint,
    )

    names = [f"{arch}_coco"]
    if arch in PRETRAINED_REGISTRY:
        names.append(PRETRAINED_REGISTRY[arch])
    for root in weights_dirs():
        for name in names:
            for suffix in (".npz", ".pt"):
                cand = Path(root) / f"{name}{suffix}"
                if not cand.exists():
                    continue
                if not verify_checkpoint(str(cand)):
                    raise ValueError(f"sha256 mismatch for checkpoint {cand}")
                if suffix == ".npz":
                    return load_params(str(cand))[0]
                return load_from_ultralytics(str(cand))["params"]

    base = hub_base()
    if base is not None and arch in PRETRAINED_REGISTRY:
        name = PRETRAINED_REGISTRY[arch]
        got = attempt_download(f"{base}/{name}.pt", Path(weights_dirs()[0]) / f"{name}.pt",
                               hash_prefix=name.rsplit("-", 1)[-1])
        return load_from_ultralytics(str(got))["params"]

    raise FileNotFoundError(
        f"No pretrained weights for '{arch}'. Place '{arch}_coco.npz' under "
        "$YOLORT_TPU_WEIGHTS or ~/.cache/yolort_tpu, or set YOLORT_HUB_BASE "
        "to a release mirror to download them.")
