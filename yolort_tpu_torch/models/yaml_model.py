"""The yaml model DSL: YOLOv5-family architectures assembled from the
ultralytics yaml config format, and generic checkpoint ingestion.

Port of ``yolort_tpu/models/yaml_model.py``.  ``parse_model`` turns a
yaml dict into a flat list of ``LayerSpec`` rows over the block zoo
(``ops/blocks.py``, ``ops/experimental.py``); ``YAMLDetectionModel``
registers each row's block under its flat layer index ("0".."N"), the
keys of the JAX params tree and of an ultralytics ``model.<i>``, so
``load_yaml_from_ultralytics`` loads any checkpoint whose yaml uses known
modules, including layouts the fixed index maps of ``_checkpoint.py``
cannot express.  Strides come from the graph (stride-2 convs, Focus,
Contract / Expand, Upsample), not from a probe forward.
"""

from __future__ import annotations

import ast
import copy
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from yolort_tpu_torch.models.darknet import make_divisible
from yolort_tpu_torch.models.head import YOLOHead
from yolort_tpu_torch.models.yolo import Detector, resolve_device
from yolort_tpu_torch.ops import blocks as B
from yolort_tpu_torch.ops.experimental import CrossConv, MixConv2d

__all__ = ["parse_model", "LayerSpec", "build_yaml_config", "load_yaml_config",
           "YAMLDetectionModel", "load_yaml_from_ultralytics"]


# blocks that take (c1, c2, ...) and scale c2 by width_multiple
_BLOCKS = {
    "Conv": B.Conv,
    "DWConv": B.DWConv,
    "GhostConv": B.GhostConv,
    "Bottleneck": B.Bottleneck,
    "GhostBottleneck": B.GhostBottleneck,
    "SPP": B.SPP,
    "SPPF": B.SPPF,
    "Focus": B.Focus,
    "BottleneckCSP": B.BottleneckCSP,
    "C3": B.C3,
    "C3TR": B.C3TR,
    "C3Ghost": B.C3Ghost,
    "CrossConv": CrossConv,
    "MixConv2d": MixConv2d,
}
# blocks whose repeat count n becomes their 3rd constructor argument
_WITH_REPEATS = {"BottleneckCSP", "C3", "C3TR", "C3Ghost"}
# blocks that take the model's activation (C3TR's convs are SiLU)
_WITH_ACT = {"Conv", "DWConv", "Bottleneck", "SPP", "SPPF", "Focus", "C3", "C3Ghost", "GhostConv"}


def _eval_arg(a, ns: Dict[str, Any]):
    """A yaml argument: literals stay literal, the names ``nc`` and
    ``anchors`` resolve from ``ns``, any other string (e.g. 'nearest')
    stays a string.  No expression is executed."""
    if not isinstance(a, str):
        return a
    try:
        return ast.literal_eval(a)
    except (ValueError, SyntaxError):
        return ns.get(a, a)


class _Repeat(nn.Module):
    """n > 1 repeats of a block outside the C3 family, children "0".."n-1"
    (the ultralytics ``nn.Sequential``)."""

    def __init__(self, blocks: Sequence[nn.Module]):
        super().__init__()
        for i, b in enumerate(blocks):
            self.add_module(str(i), b)
        self.s = getattr(blocks[0], "s", 1)

    def forward(self, x):
        for b in self.children():
            x = b(x)
        return x


@dataclass(frozen=True)
class LayerSpec:
    """One parsed yaml row: [from, number, module, args]."""

    i: int
    f: Tuple[int, ...]  # absolute input indices; -1 = the previous row
    kind: str  # 'block' | 'upsample' | 'concat' | 'contract' | 'expand'
    #            | 'batchnorm' | 'maxpool' | 'detect'
    name: str  # the module name of the yaml
    block: Optional[nn.Module] = None  # the row's module ('block', 'batchnorm', 'detect')
    extra: Tuple = ()  # the kind's static arguments


def _upsample(x, scale: int):
    """Nearest-neighbour upsample by an integer ``scale``."""
    if scale == 2:
        return B.upsample2x(x)
    y = x.repeat_interleave(scale, dim=2).repeat_interleave(scale, dim=3)
    return y.contiguous(memory_format=torch.channels_last)


def parse_model(d: Dict[str, Any], ch: Sequence[int] = (3,), act: str = "silu", *,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[List[LayerSpec], List[int], Dict[str, Any]]:
    """yaml dict -> (layer specs, save list, meta), as the JAX package
    parses it: depth gain max(round(n * gd), 1), widths make_divisible(c2
    * gw, 8), repeats folded into the C3 family's ``n``.  ``meta`` carries
    nc, anchor_grids, strides and the Detect row's inputs.  The blocks
    draw their weights from ``gen`` (``torch.Generator(0)`` if None)."""
    gen = torch.Generator().manual_seed(0) if gen is None else gen
    anchors, nc = d["anchors"], int(d["nc"])
    gd, gw = float(d["depth_multiple"]), float(d["width_multiple"])
    na = (len(anchors[0]) // 2) if isinstance(anchors, list) else int(anchors)
    no = na * (nc + 5)
    ns = {"nc": nc, "anchors": anchors, "None": None}

    ch = list(ch)
    scales: List[float] = [1.0]  # the spatial downscale of each entry of ch
    layers: List[LayerSpec] = []
    save: List[int] = []
    meta: Dict[str, Any] = {"nc": nc}

    for i, (f, n, m, args) in enumerate(list(d["backbone"]) + list(d["head"])):
        name = m if isinstance(m, str) else getattr(m, "__name__", str(m))
        args = [_eval_arg(a, ns) for a in args]
        n = max(round(n * gd), 1) if n > 1 else n
        f_t = tuple(f) if isinstance(f, (list, tuple)) else (f,)
        in_ch = ch[f_t[0]]
        in_scale = scales[f_t[0]]
        out_scale = in_scale

        if name in _BLOCKS:
            c2 = args[0]
            if c2 != no:
                c2 = make_divisible(c2 * gw, 8)
            bargs = [in_ch, c2, *args[1:]]
            cls = _BLOCKS[name]
            if name in _WITH_REPEATS:
                bargs.insert(2, n)
                n = 1
            kw = {"act": act} if name in _WITH_ACT else {}
            # the reference repeats the module with identical arguments
            block = (_Repeat([cls(*bargs, **kw, gen=gen) for _ in range(n)]) if n > 1
                     else cls(*bargs, **kw, gen=gen))
            s = getattr(block, "s", 1)
            out_scale = in_scale * (s if isinstance(s, int) else 1)
            if name == "Focus":
                out_scale *= 2  # space-to-depth halves H and W before the conv
            layers.append(LayerSpec(i, f_t, "block", name, block))
        elif name in ("nn.BatchNorm2d", "BatchNorm2d"):
            c2 = in_ch
            layers.append(LayerSpec(i, f_t, "batchnorm", name, B.BatchNorm(c2)))
        elif name == "Concat":
            c2 = sum(ch[x] for x in f_t)
            layers.append(LayerSpec(i, f_t, "concat", name))
        elif name in ("nn.Upsample", "Upsample"):
            scale = int(args[1]) if len(args) > 1 and args[1] else 2
            c2 = in_ch
            out_scale = in_scale / scale
            layers.append(LayerSpec(i, f_t, "upsample", name, extra=(scale,)))
        elif name == "Contract":
            g = int(args[0])
            c2 = in_ch * g * g
            out_scale = in_scale * g
            layers.append(LayerSpec(i, f_t, "contract", name, extra=(g,)))
        elif name == "Expand":
            g = int(args[0])
            c2 = in_ch // (g * g)
            out_scale = in_scale / g
            layers.append(LayerSpec(i, f_t, "expand", name, extra=(g,)))
        elif name in ("nn.MaxPool2d", "MaxPool2d"):
            k = int(args[0])
            s = int(args[1]) if len(args) > 1 else k
            p = int(args[2]) if len(args) > 2 else 0
            c2 = in_ch
            out_scale = in_scale * s
            layers.append(LayerSpec(i, f_t, "maxpool", name, extra=(k, s, p)))
        elif name == "Detect":
            det_nc = int(args[0])
            det_anchors = args[1]
            if isinstance(det_anchors, int):  # an anchor count only
                det_anchors = [list(range(det_anchors * 2))] * len(f_t)
            strides = tuple(int(scales[x]) for x in f_t)
            in_channels = tuple(ch[x] for x in f_t)
            meta.update(
                nc=det_nc,
                anchor_grids=tuple(tuple(float(v) for v in a) for a in det_anchors),
                strides=strides,
                detect_from=f_t,
                detect_index=i,
                detect_in_channels=in_channels,
            )
            head = YOLOHead(in_channels, len(det_anchors[0]) // 2, strides, det_nc, gen=gen)
            layers.append(LayerSpec(i, f_t, "detect", name, head))
            c2 = ch[-1]
        else:
            raise ValueError(f"Unsupported yaml module '{name}' (layer {i})")

        save.extend(x % i for x in f_t if x != -1)
        if i == 0:
            ch, scales = [], []
        ch.append(c2)
        scales.append(out_scale)

    if "detect_from" not in meta:
        raise ValueError("yaml config has no Detect layer")
    return layers, sorted(set(save)), meta


def load_yaml_config(path: str) -> Dict[str, Any]:
    """A yaml file as a config dict (PyYAML, imported here: nothing on the
    serving path reads a file)."""
    import yaml

    with open(path) as fh:
        return yaml.safe_load(fh)


_SIZE_MULTIPLES = {"n": (0.33, 0.25), "s": (0.33, 0.5), "m": (0.67, 0.75),
                   "l": (1.0, 1.0), "x": (1.33, 1.25)}

# the canonical v6.0 row lists (the reference's yolov5s.yaml and
# yolov5s6.yaml; the n/s/m/l/x variants differ only in the multiples)
_P5_BACKBONE = [
    [-1, 1, "Conv", [64, 6, 2, 2]],
    [-1, 1, "Conv", [128, 3, 2]],
    [-1, 3, "C3", [128]],
    [-1, 1, "Conv", [256, 3, 2]],
    [-1, 6, "C3", [256]],
    [-1, 1, "Conv", [512, 3, 2]],
    [-1, 9, "C3", [512]],
    [-1, 1, "Conv", [1024, 3, 2]],
    [-1, 3, "C3", [1024]],
    [-1, 1, "SPPF", [1024, 5]],
]
_P5_HEAD = [
    [-1, 1, "Conv", [512, 1, 1]],
    [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
    [[-1, 6], 1, "Concat", [1]],
    [-1, 3, "C3", [512, False]],
    [-1, 1, "Conv", [256, 1, 1]],
    [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
    [[-1, 4], 1, "Concat", [1]],
    [-1, 3, "C3", [256, False]],
    [-1, 1, "Conv", [256, 3, 2]],
    [[-1, 14], 1, "Concat", [1]],
    [-1, 3, "C3", [512, False]],
    [-1, 1, "Conv", [512, 3, 2]],
    [[-1, 10], 1, "Concat", [1]],
    [-1, 3, "C3", [1024, False]],
    [[17, 20, 23], 1, "Detect", ["nc", "anchors"]],
]
_P5_ANCHORS = [[10, 13, 16, 30, 33, 23], [30, 61, 62, 45, 59, 119],
               [116, 90, 156, 198, 373, 326]]

_P6_BACKBONE = [
    [-1, 1, "Conv", [64, 6, 2, 2]],
    [-1, 1, "Conv", [128, 3, 2]],
    [-1, 3, "C3", [128]],
    [-1, 1, "Conv", [256, 3, 2]],
    [-1, 6, "C3", [256]],
    [-1, 1, "Conv", [512, 3, 2]],
    [-1, 9, "C3", [512]],
    [-1, 1, "Conv", [768, 3, 2]],
    [-1, 3, "C3", [768]],
    [-1, 1, "Conv", [1024, 3, 2]],
    [-1, 3, "C3", [1024]],
    [-1, 1, "SPPF", [1024, 5]],
]
_P6_HEAD = [
    [-1, 1, "Conv", [768, 1, 1]],
    [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
    [[-1, 8], 1, "Concat", [1]],
    [-1, 3, "C3", [768, False]],
    [-1, 1, "Conv", [512, 1, 1]],
    [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
    [[-1, 6], 1, "Concat", [1]],
    [-1, 3, "C3", [512, False]],
    [-1, 1, "Conv", [256, 1, 1]],
    [-1, 1, "nn.Upsample", ["None", 2, "nearest"]],
    [[-1, 4], 1, "Concat", [1]],
    [-1, 3, "C3", [256, False]],
    [-1, 1, "Conv", [256, 3, 2]],
    [[-1, 20], 1, "Concat", [1]],
    [-1, 3, "C3", [512, False]],
    [-1, 1, "Conv", [512, 3, 2]],
    [[-1, 16], 1, "Concat", [1]],
    [-1, 3, "C3", [768, False]],
    [-1, 1, "Conv", [768, 3, 2]],
    [[-1, 12], 1, "Concat", [1]],
    [-1, 3, "C3", [1024, False]],
    [[23, 26, 29, 32], 1, "Detect", ["nc", "anchors"]],
]
_P6_ANCHORS = [[19, 27, 44, 40, 38, 94], [96, 68, 86, 152, 180, 137],
               [140, 301, 303, 264, 238, 542], [436, 615, 739, 380, 925, 792]]


def build_yaml_config(size: str = "s", p6: bool = False, num_classes: int = 80) -> Dict[str, Any]:
    """The canonical yolov5{n,s,m,l,x}(6) config dict."""
    dm, wm = _SIZE_MULTIPLES[size]
    return {
        "nc": num_classes,
        "depth_multiple": dm,
        "width_multiple": wm,
        "anchors": copy.deepcopy(_P6_ANCHORS if p6 else _P5_ANCHORS),
        "backbone": copy.deepcopy(_P6_BACKBONE if p6 else _P5_BACKBONE),
        "head": copy.deepcopy(_P6_HEAD if p6 else _P5_HEAD),
    }


class YAMLDetectionModel(Detector):
    """A detection model assembled from a yaml config dict, with the surface
    of ``YOLO`` (``Detector``): ``features`` walks the layer graph up to
    the Detect row (``head``), each row's block a child named by its flat
    index.  ``anchor_grids_override`` replaces the yaml's anchors (a
    checkpoint's Detect buffers, which auto-anchor may have changed);
    ``postprocess`` holds ``Detector``'s keywords.  Weights are drawn from ``torch.Generator(seed)``, then the
    module moves to ``device`` (the card unless the caller passes
    ``"cpu"``) and ``dtype``."""

    def __init__(
        self,
        cfg: Dict[str, Any],
        act: str = "silu",
        *,
        device="cuda",
        dtype: torch.dtype = torch.float32,
        anchor_grids_override: Optional[Sequence[Sequence[float]]] = None,
        seed: int = 0,
        **postprocess,
    ):
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        layers, save, meta = parse_model(cfg, act=act, gen=gen)
        if anchor_grids_override is not None:
            ag = tuple(tuple(float(v) for v in a) for a in anchor_grids_override)
            meta = dict(meta, anchor_grids=ag)
            det = layers[-1]
            if det.block.num_anchors != len(ag[0]) // 2:
                head = YOLOHead(meta["detect_in_channels"], len(ag[0]) // 2, meta["strides"],
                                meta["nc"], gen=gen)
                layers[-1] = LayerSpec(det.i, det.f, det.kind, det.name, head)
        super().__init__(num_classes=meta["nc"], strides=meta["strides"],
                         anchor_grids=meta["anchor_grids"], **postprocess)
        self.layers = tuple(layers)
        self.save = frozenset(save)
        self.meta = meta
        for spec in self.layers:
            if spec.block is not None:
                self.add_module(str(spec.i), spec.block)
        self.place(device, dtype)

    @property
    def head(self) -> YOLOHead:
        return self._modules[str(self.meta["detect_index"])]

    def features(self, images: torch.Tensor) -> List[Any]:
        """images (B, H, W, 3) -> the Detect row's inputs, walking the layer
        graph (channels_last NCHW)."""
        saved: Dict[int, Any] = {}
        x = self.nchw(images)
        for spec in self.layers:
            ins = [x if j == -1 else saved[j] for j in spec.f]
            block = self._modules.get(str(spec.i))
            if spec.kind == "detect":
                return ins
            if spec.kind == "block":
                x = block(ins[0])
            elif spec.kind == "batchnorm":
                x = block(B._as_float(ins[0]))
            elif spec.kind == "concat":
                x = B._qconcat(ins)
            elif spec.kind == "upsample":
                x = _upsample(ins[0], spec.extra[0])
            elif spec.kind == "contract":
                x = B.contract(ins[0], spec.extra[0])
            elif spec.kind == "expand":
                x = B.expand(ins[0], spec.extra[0])
            elif spec.kind == "maxpool":  # padded with -inf
                x = F.max_pool2d(ins[0], *spec.extra)
            if spec.i in self.save:
                saved[spec.i] = x
        raise AssertionError("unreachable: parse_model guarantees a Detect row")


def load_yaml_from_ultralytics(checkpoint_path: str, fuse: bool = True, act: str = "silu",
                               **model_kwargs) -> YAMLDetectionModel:
    """A ``YAMLDetectionModel`` of an ultralytics ``.pt``, built from the yaml
    the pickled model carries: any architecture of known modules.  The
    anchors come from the Detect buffers (in stride units there); the
    stride from Detect's buffers, its attributes, or the model's.  Each
    row's weights load from ``model.<i>`` (BatchNorm folded into its conv,
    as ``_checkpoint.convert_module`` does, unless ``fuse`` is False: then
    each Conv keeps its BatchNorm leaves; Detect's convs are under its
    ``m``).  ``model_kwargs`` go to the model: ``device`` (the card unless
    ``"cpu"``), ``dtype``, the postprocess configuration."""
    from yolort_tpu_torch.models._bridge import params_from_jax
    from yolort_tpu_torch.models._checkpoint import (
        _buffers_of, _children, _np, _seq_children, convert_module, load_torch_checkpoint,
    )

    ckpt = load_torch_checkpoint(checkpoint_path)
    model = (ckpt.get("ema") or ckpt["model"]) if isinstance(ckpt, dict) else ckpt
    yaml_cfg = object.__getattribute__(model, "__dict__").get("yaml")
    if not yaml_cfg or "backbone" not in yaml_cfg or "head" not in yaml_cfg:
        raise ValueError(f"checkpoint {checkpoint_path} carries no full yaml config "
                         "(backbone/head rows required for generic ingestion)")

    flat = _seq_children(_children(model)["model"])
    detect = flat[-1]
    det_buf = _buffers_of(detect)
    anchors = _np(det_buf["anchors"])  # (nl, na, 2) in stride units
    stride_t = det_buf.get("stride")
    if stride_t is None:
        stride_t = object.__getattribute__(detect, "__dict__").get("stride")
    if stride_t is None:
        stride_t = object.__getattribute__(model, "__dict__").get("stride")
    strides = np.asarray(_np(stride_t)).reshape(-1)
    anchor_grids = tuple(tuple(float(v) for v in (a * s).reshape(-1))
                         for a, s in zip(anchors, strides))

    m = YAMLDetectionModel(yaml_cfg, act=act, anchor_grids_override=anchor_grids, **model_kwargs)
    params: Dict[str, Any] = {}
    for spec in m.layers:
        if spec.block is None:
            continue
        converted = convert_module(flat[spec.i], fuse)
        params[str(spec.i)] = converted["m"] if spec.kind == "detect" else converted
    params_from_jax(params, m)
    return m
