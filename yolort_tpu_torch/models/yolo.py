"""YOLO model: backbone -> PAN -> head -> postprocess.

Port of ``yolort_tpu/models/yolo.py``: the r3.1, r4.0 and r6.0 families,
P6 (four levels, strides 8-64) and the TAN variant, and the registry of
the JAX package's 17 architectures.  ``Detector`` is the surface YOLO
shares with ``YOLOLite`` and ``YAMLDetectionModel``: it takes NHWC
images, runs the network in channels_last NCHW, returns NHWC head
outputs, decoded predictions and padded ``Detections``.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from yolort_tpu_torch.models.darknet import DarkNet, make_divisible
from yolort_tpu_torch.models.head import (
    DEFAULT_ANCHOR_GRIDS, DEFAULT_STRIDES, P6_ANCHOR_GRIDS, P6_STRIDES, YOLOHead,
    concat_pred_logits,
)
from yolort_tpu_torch.models.pan import PathAggregationNetwork
from yolort_tpu_torch.ops import blocks
from yolort_tpu_torch.ops.nms import (
    Detections, batched_postprocess, batched_postprocess_from_heads,
)
from yolort_tpu_torch.utils.graphs import GraphCache
from yolort_tpu_torch.utils.profiling import count, recording, span


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device where torch sees none
    raises: the port runs on the card unless the caller asks for the CPU,
    and never falls back to it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} needs a CUDA device and torch sees none; "
                           f"pass device='cpu' to run on the CPU")
    return dev


class Detector(nn.Module):
    """What every detection model of the port shares: the anchors, the
    postprocess configuration and the path from images to ``Detections``.
    ``YOLO``, ``YOLOLite`` and ``YAMLDetectionModel`` build their networks,
    a ``head`` (``YOLOHead``) and ``features`` (images -> the head's
    inputs).

    The postprocess thresholds are plain attributes (the defaults are the
    eval config), and so are ``classes_per_anchor`` (None: the cell path;
    C: each anchor's best C classes, on the flatten path) and the stage-2
    route ``row_gather`` (``ops.nms.NMSConfig``; any route gives the same
    detections).  A built model serves frozen (no parameter requires
    grad); ``init_train`` / ``trainable`` make it trainable.  On a card
    the network runs as a CUDA graph of its input's shape where
    ``utils/graphs.py``'s rule holds (``head_outputs``)."""

    def __init__(
        self,
        *,
        num_classes: int,
        strides: Sequence[int],
        anchor_grids: Sequence[Sequence[float]],
        score_thresh: float = 0.005,
        nms_thresh: float = 0.45,
        detections_per_img: int = 300,
        pre_nms_topk: int = 4096,
        pre_nms_anchors: Optional[int] = None,
        classes_per_anchor: Optional[int] = None,
        nms_tile_size: int = 256,
        row_gather: str = "pallas_bisect",
    ):
        super().__init__()
        self._graphs = GraphCache()
        self.num_classes = num_classes
        self.strides = tuple(strides)
        self.anchor_grids = tuple(tuple(a) for a in anchor_grids)
        self.score_thresh = score_thresh
        self.nms_thresh = nms_thresh
        self.detections_per_img = detections_per_img
        self.pre_nms_topk = pre_nms_topk
        self.pre_nms_anchors = pre_nms_anchors
        self.classes_per_anchor = classes_per_anchor
        self.nms_tile_size = nms_tile_size
        self.row_gather = row_gather

    def place(self, device: torch.device, dtype: torch.dtype) -> None:
        """Freeze the built network and move it to ``device`` and ``dtype``,
        channels_last."""
        self.eval().requires_grad_(False)  # inference only: no autograd graph
        self.to(device=device, dtype=dtype, memory_format=torch.channels_last)

    @property
    def num_anchors(self) -> int:
        return len(self.anchor_grids[0]) // 2

    def init_train(self, seed: int = 0) -> "Detector":
        """The train form from ``torch.Generator(seed)``: JAX's ``init``
        (every Conv unfused, w U(-b, b) with b = 1/sqrt(fan_in), gamma 1,
        beta 0, mean 0, var 1; the head's prior-probability bias), every
        leaf a parameter that requires grad.  In place; returns self."""
        self.trainable()
        blocks.init_train(self, torch.Generator().manual_seed(seed))
        self.head.add_prior_bias()
        return self

    def trainable(self) -> "Detector":
        """Every parameter requires grad (the weights as they are: fused
        convs train their weight and bias, unfused ones their BatchNorm
        too).  An int8-quantized model raises.  In place; returns self."""
        for m in self.modules():
            if isinstance(m, blocks._Int8Conv) and m.quantized:
                raise ValueError("an int8-quantized model cannot be trained")
        return self.requires_grad_(True)

    @staticmethod
    def nchw(images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images as the network's channels_last (B, 3, H, W)."""
        return images.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)

    def features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """images (B, H, W, 3) letterboxed float -> the head's inputs."""
        raise NotImplementedError

    def head_outputs(self, images: torch.Tensor) -> List[torch.Tensor]:
        """Per-level raw logits (B, Hl, Wl, A*(5+nc)), NHWC.  On a card with
        grad off, from a shape's second call on, a replay of the network's
        CUDA graph (``utils/graphs.py``), the eager outputs bit for bit:
        inside ``forward`` and ``decode`` the graph's own output tensors,
        elsewhere copies of them.

        Counters while the profiler records: ``epilogue_fused`` and
        ``epilogue_plain``, the network's biased float convs whose bias
        and activation the ``bias_act`` kernel applies at this call, and
        the rest (``blocks.fused_epilogue`` on the images decides for
        every conv of the network), on a replay as on an eager call."""
        outs = self._graphs.run(self, self._network, images)
        if recording():
            n = blocks.biased_float_convs(self)
            fused = n if blocks.fused_epilogue(images) else 0
            count("epilogue_fused", fused)
            count("epilogue_plain", n - fused)
        return outs

    def _network(self, images: torch.Tensor) -> List[torch.Tensor]:
        return self.head(self.features(images))

    def decode(self, images: torch.Tensor) -> torch.Tensor:
        """Decoded predictions (B, total_anchors, 5+nc) f32 in canvas pixels:
        everything but the NMS."""
        with self._graphs.borrow():
            outs = self.head_outputs(images)
            return concat_pred_logits(outs, [tuple(o.shape[1:3]) for o in outs], self.strides,
                                      self.anchor_grids)

    def postprocess(self, head_outputs: Sequence[torch.Tensor]) -> Detections:
        """Padded detections, in canvas coordinates, of per-level logits."""
        return batched_postprocess_from_heads(
            head_outputs, self.strides, self.anchor_grids,
            num_classes=self.num_classes, score_thresh=self.score_thresh,
            nms_thresh=self.nms_thresh, detections_per_img=self.detections_per_img,
            pre_nms_topk=self.pre_nms_topk, pre_nms_anchors=self.pre_nms_anchors,
            classes_per_anchor=self.classes_per_anchor, nms_tile_size=self.nms_tile_size,
            row_gather=self.row_gather,
        )

    def postprocess_decoded(self, pred: torch.Tensor) -> Detections:
        """Padded detections of decoded predictions (B, Na, 5+nc) (``decode``
        of this model, or a pool of them: Ensemble, TTA) under this model's
        thresholds and ``row_gather`` route."""
        with span("postprocess"):
            return batched_postprocess(
                pred, num_classes=self.num_classes, score_thresh=self.score_thresh,
                nms_thresh=self.nms_thresh, detections_per_img=self.detections_per_img,
                pre_nms_topk=self.pre_nms_topk, nms_tile_size=self.nms_tile_size,
                row_gather=self.row_gather,
            )

    def with_thresholds(self, score_thresh=None, nms_thresh=None, detections_per_img=None,
                        pre_nms_topk=None) -> "Detector":
        """A view of this model with the given postprocess thresholds (those
        left None keep theirs): a shallow copy sharing every weight."""
        out = copy.copy(self)
        for key, v in (("score_thresh", score_thresh), ("nms_thresh", nms_thresh),
                       ("detections_per_img", detections_per_img), ("pre_nms_topk", pre_nms_topk)):
            if v is not None:
                setattr(out, key, v)
        return out

    def forward(self, images: torch.Tensor) -> Detections:
        """images (B, H, W, 3) letterboxed -> padded Detections, canvas coordinates."""
        # held through the postprocess's launches: they read the graph's
        # outputs, which the next replay overwrites
        with self._graphs.borrow():
            with span("network"):
                outs = self.head_outputs(images)
            with span("postprocess"):
                return self.postprocess(outs)


class YOLO(Detector):
    """YOLOv5: CSPDarknet, PAN and the head.  ``depth_multiple`` /
    ``width_multiple`` select the size, ``version`` the family ('r3.1',
    'r4.0', 'r6.0'), ``use_p6`` the fourth level (with its strides and
    anchors unless given), ``use_tan`` the C3TR first inner block; the
    other keywords are ``Detector``'s postprocess configuration.  Weights
    are drawn from ``torch.Generator(seed)`` on the CPU, then the module
    moves to ``device`` (the card unless the caller passes ``"cpu"``) and
    ``dtype``."""

    def __init__(
        self,
        depth_multiple: float,
        width_multiple: float,
        *,
        device="cuda",
        dtype: torch.dtype = torch.float32,
        version: str = "r6.0",
        num_classes: int = 80,
        use_p6: bool = False,
        use_tan: bool = False,
        strides: Optional[Sequence[int]] = None,
        anchor_grids: Optional[Sequence[Sequence[float]]] = None,
        seed: int = 0,
        **postprocess,
    ):
        device = resolve_device(device)
        super().__init__(
            num_classes=num_classes,
            strides=strides or (P6_STRIDES if use_p6 else DEFAULT_STRIDES),
            anchor_grids=anchor_grids or (P6_ANCHOR_GRIDS if use_p6 else DEFAULT_ANCHOR_GRIDS),
            **postprocess)
        self.version = version
        gen = torch.Generator().manual_seed(seed)
        widths = (256, 512, 768, 1024) if use_p6 else (256, 512, 1024)
        in_channels = tuple(make_divisible(c * width_multiple, 8) for c in widths)
        self.backbone = DarkNet(depth_multiple, width_multiple, version,
                                last_channel=768 if use_p6 else 1024, gen=gen)
        self.pan = PathAggregationNetwork(in_channels, depth_multiple, version, use_p6,
                                          first_inner="c3tr" if use_tan else "auto", gen=gen)
        self.head = YOLOHead(in_channels, self.num_anchors, self.strides, num_classes, gen=gen)
        self.place(device, dtype)

    def features(self, images: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        """images (B, H, W, 3) letterboxed float -> PAN outputs (channels_last NCHW)."""
        return self.pan(self.backbone(self.nchw(images)))


_SIZES = {"n": (0.33, 0.25), "s": (0.33, 0.5), "m": (0.67, 0.75), "l": (1.0, 1.0), "x": (1.33, 1.25)}

# name -> (size, version, use_p6, use_tan), the JAX package's registry
ARCHS = {
    **{f"yolov5_darknet_pan_{s}_{v.replace('.', '')}": (s, v, False, False)
       for v in ("r3.1", "r4.0") for s in "sml"},
    **{f"yolov5_darknet_pan_{s}_r60": (s, "r6.0", False, False) for s in _SIZES},
    **{f"yolov5_darknet_pan_{s}6_r60": (s, "r6.0", True, False) for s in _SIZES},
    "yolov5_darknet_tan_s_r40": ("s", "r4.0", False, True),
}


def build_yolo(arch: str, *, device="cuda", num_classes: int = 80, **kwargs) -> YOLO:
    if arch not in ARCHS:
        raise ValueError(f"Unknown arch '{arch}'. Available: {sorted(ARCHS)}")
    size, version, use_p6, use_tan = ARCHS[arch]
    return YOLO(*_SIZES[size], device=device, version=version, num_classes=num_classes,
                use_p6=use_p6, use_tan=use_tan, **kwargs)
