"""End-to-end YOLOv5: letterbox + model + postprocess + box rescale.

Port of ``yolort_tpu/models/yolov5.py``.  ``__call__`` groups images of one
raw size into a batch (a shape bucket) and runs the whole pipeline on the
model's device: uint8 frames are normalised there, float images are taken
as [0, 1].  With ``fixed_shape`` every canvas is that size, and a request
of mixed sizes is served as one batch: each frame is uploaded as it is,
letterboxed on the device into its slice of one canvas
(``letterbox_images``) and its boxes scaled back with its own size
(``_infer_fixed``).  On a card a request's frames and sizes reach the
device in one asynchronous copy a batch through the instance's pinned
staging arena (``utils.staging.StagingArena``).  ``predict_rich`` wraps
the detections in ``utils.results.DetectionResults``;
``load_from_yolov5`` builds a model from an ultralytics checkpoint,
``pretrained=True`` from the weights directory.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from yolort_tpu_torch.models._bridge import params_from_jax
from yolort_tpu_torch.models._checkpoint import load_from_ultralytics, load_pretrained_params
from yolort_tpu_torch.models.transform import (
    letterbox_batch, letterbox_images, make_plan, scale_coords_back,
)
from yolort_tpu_torch.models.yolo import YOLO, Detector, build_yolo, resolve_device
from yolort_tpu_torch.ops.nms import Detections
from yolort_tpu_torch.utils import profiling
from yolort_tpu_torch.utils.profiling import span
from yolort_tpu_torch.utils.staging import StagingArena


def read_image(path: str) -> np.ndarray:
    """Default loader: RGB float32 in [0, 1], HWC."""
    import cv2

    img = cv2.imread(str(path), cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(f"cannot read image: {path}")
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


class YOLOv5:
    """User-facing end-to-end model.  ``size`` is the (min_size, max_size)
    letterbox target, ``size_divisible`` the canvas rounding,
    ``fixed_shape`` pins the canvas (h, w) (then images of mixed sizes
    share one batch), ``fill_color`` the pad value; ``device`` (the card unless the caller
    passes ``"cpu"``; a CUDA device where there is none raises) and
    ``dtype`` (float32 or bfloat16) place the model.  ``pretrained`` loads
    ``arch``'s COCO weights from the local weights directory
    (``_checkpoint.load_pretrained_params``) onto the model's device and
    dtype, in place of the seeded ones; ``progress`` is kept for the
    reference's signature and unused.  A ``model`` passed in (any
    ``Detector``: YOLO, YOLOLite, YAMLDetectionModel; or an ``Ensemble``)
    is served where its parameters lie, with its own weights; a ``device``
    given beside it must be that one."""

    def __init__(
        self,
        arch: Optional[str] = None,
        model: Optional[Detector] = None,
        *,
        device=None,
        num_classes: int = 80,
        pretrained: bool = False,
        progress: bool = True,
        size: Tuple[int, int] = (640, 640),
        size_divisible: int = 32,
        fixed_shape: Optional[Tuple[int, int]] = None,
        fill_color: int = 114,
        dtype: torch.dtype = torch.float32,
        seed: int = 0,
        **kwargs: Any,
    ) -> None:
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        if model is None:
            device = resolve_device("cuda" if device is None else device)
            model = build_yolo(arch, device=device, num_classes=num_classes, dtype=dtype,
                               seed=seed, **kwargs)
            if pretrained:
                params_from_jax(load_pretrained_params(arch), model)
        elif pretrained:
            raise ValueError("pretrained=True loads the weights of the arch's model; a model "
                             "passed in keeps its own")
        else:
            # a quantized model keeps its weights as buffers, not parameters
            first = next(itertools.chain(model.parameters(), model.buffers()))
            where = first.device
            device = where if device is None else resolve_device(device)
            if device.type != where.type or device.index not in (None, where.index):
                raise ValueError(f"device {str(device)!r} differs from the model's {str(where)!r}")
        self.arch = arch
        self.model = model
        self.device = device
        self.num_classes = model.num_classes
        self.size = size
        self.size_divisible = size_divisible
        self.fixed_shape = None if fixed_shape is None else (int(fixed_shape[0]),
                                                             int(fixed_shape[1]))
        self.fill_color = fill_color
        self.dtype = dtype
        self._calls = 0  # calls so far: the request span's sequence number
        # page-locked host buffer of the largest request seen, on a card only
        self._arena = StagingArena() if self.device.type == "cuda" else None

    @classmethod
    def load_from_yolov5(
        cls,
        checkpoint_path: str,
        *,
        version: str = "r6.0",
        device="cuda",
        dtype: torch.dtype = torch.float32,
        size: Tuple[int, int] = (640, 640),
        size_divisible: int = 32,
        fixed_shape: Optional[Tuple[int, int]] = None,
        fill_color: int = 114,
        score_thresh: float = 0.25,
        nms_thresh: float = 0.45,
        **kwargs: Any,
    ) -> "YOLOv5":
        """Build from an ultralytics/yolov5 checkpoint: the architecture
        (depth, width, classes, P6, strides and anchors, and the TAN
        variant's C3TR at flat layer 9) from its metadata and layers, the
        weights from its tree (``models/_checkpoint.py``).  ``version``
        names the family, as the checkpoint does not; a TAN checkpoint
        loads as 'r4.0'.  ``kwargs`` go on to ``YOLO``; a ``use_tan`` among
        them that contradicts the checkpoint raises ``ValueError``."""
        info = load_from_ultralytics(checkpoint_path, version=version)
        use_tan = bool(kwargs.pop("use_tan", info["use_tan"]))
        if use_tan != info["use_tan"]:
            raise ValueError(f"use_tan={use_tan}, but the checkpoint's layer model.9 is "
                             f"{'a' if info['use_tan'] else 'not a'} C3TR")
        model = YOLO(info["depth_multiple"], info["width_multiple"], device=device, dtype=dtype,
                     version=version, num_classes=info["num_classes"], use_p6=info["use_p6"],
                     use_tan=use_tan, strides=info["strides"], anchor_grids=info["anchor_grids"],
                     score_thresh=score_thresh, nms_thresh=nms_thresh, **kwargs)
        params_from_jax(info["params"], model)
        return cls(model=model, size=size, size_divisible=size_divisible, fixed_shape=fixed_shape,
                   fill_color=fill_color, dtype=dtype)

    def _plans(self, sizes) -> list:
        plans = make_plan(sizes, min_size=self.size[0], max_size=self.size[1],
                          size_divisible=self.size_divisible, fixed_shape=self.fixed_shape)
        for p in plans:
            if p.resized_hw[0] > p.canvas_hw[0] or p.resized_hw[1] > p.canvas_hw[1]:
                raise ValueError(f"an image resized to {p.resized_hw} (size {self.size}) does not "
                                 f"fit the fixed_shape canvas {p.canvas_hw}")
        return plans

    def _to_unit(self, raw: torch.Tensor) -> torch.Tensor:
        """uint8 frames normalised to [0, 1], float ones taken as they are,
        in the model dtype."""
        return raw.to(self.dtype) * (1.0 / 255.0) if raw.dtype == torch.uint8 else raw.to(self.dtype)

    def canvas(self, raw: torch.Tensor):
        """(canvas, plan) of raw (B, H, W, 3) uint8 or float in [0, 1], one
        shape bucket: the letterboxed batch the model takes, in its dtype,
        and the ``LetterboxPlan`` that made it (onto ``fixed_shape`` where
        it is set)."""
        _, h, w, _ = raw.shape
        with span("letterbox"):
            plan = self._plans([(h, w)])[0]
            return letterbox_batch(self._to_unit(raw), plan, self.fill_color / 255.0), plan

    def canvas_mixed(self, raws: Sequence[torch.Tensor]) -> torch.Tensor:
        """The ``fixed_shape`` canvas (B, ch, cw, 3) of frames (H_i, W_i, 3)
        of any sizes, each letterboxed into its slice on their device; a
        slice equals ``canvas`` of its frame alone, bit for bit."""
        if self.fixed_shape is None:
            raise ValueError("images of mixed sizes share a batch only with fixed_shape set")
        with span("letterbox"):
            plans = self._plans([tuple(r.shape[:2]) for r in raws])
            return letterbox_images([self._to_unit(r) for r in raws], plans,
                                    self.fill_color / 255.0)

    @torch.inference_mode()
    def _infer(self, raw: torch.Tensor, orig_hw: torch.Tensor) -> Detections:
        """raw: (B, H, W, 3) uint8 or float in [0, 1], one shape bucket, on
        the model's device; ``orig_hw`` its (2,) f32 ``[H, W]`` there."""
        canvas, plan = self.canvas(raw)
        det = self.model(canvas)
        with span("rescale"):
            return det._replace(boxes=scale_coords_back(det.boxes, plan.canvas_hw, orig_hw))

    @torch.inference_mode()
    def _infer_fixed(self, canvases: torch.Tensor, orig_hw: torch.Tensor) -> Detections:
        """Inference on letterboxed ``fixed_shape`` canvases (B, ch, cw, 3)
        of frames of any sizes; each image's boxes scaled back with its own
        ``orig_hw`` (B, 2) f32 row."""
        det = self.model(canvases.to(self.dtype))
        with span("rescale"):
            return det._replace(boxes=scale_coords_back(det.boxes, self.fixed_shape,
                                                        orig_hw[:, None, :]))

    @staticmethod
    def _unpack(det: Detections, idxs: Sequence[int], results: list) -> None:
        """The batch's detections read back into ``results`` at ``idxs``,
        then the request's held counts and ``kept``."""
        with span("readback"):
            boxes, scores, labels, num = (
                det.boxes.float().cpu().numpy(), det.scores.float().cpu().numpy(),
                det.labels.cpu().numpy(), det.num.cpu().numpy(),
            )
            for j, i in enumerate(idxs):
                n = int(num[j])
                results[i] = {
                    "boxes": boxes[j, :n],
                    "scores": scores[j, :n],
                    "labels": labels[j, :n].astype(np.int64),
                }
            profiling.emit_held_counts()
            profiling.count("kept", num.sum())

    def __call__(self, inputs: Sequence[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        """Detect on a list of HWC images (uint8, or float in [0, 1]).
        Same-size images of one dtype share a batch; with ``fixed_shape``
        set, a request of several sizes or dtypes is one batch on the
        fixed canvas (``canvas_mixed``, ``_infer_fixed``)."""
        self._calls += 1
        with profiling.request(self._calls):
            return self._serve(inputs)

    def _serve(self, inputs: Sequence[np.ndarray]) -> List[Dict[str, np.ndarray]]:
        with span("stack"):
            images = [np.asarray(x) for x in inputs]
            results: List[Optional[Dict[str, np.ndarray]]] = [None] * len(images)
            groups: Dict[Tuple[Tuple[int, int], np.dtype], List[int]] = {}
            for i, im in enumerate(images):
                if im.ndim != 3 or im.shape[-1] != 3:
                    raise ValueError(f"expected an HWC image with 3 channels, got shape {im.shape}")
                dt = np.dtype(np.uint8) if im.dtype == np.uint8 else np.dtype(np.float32)
                images[i] = im.astype(dt, copy=False)
                groups.setdefault((im.shape[:2], dt), []).append(i)
        if self.fixed_shape is not None and len(groups) > 1:
            with torch.inference_mode():
                *raws, orig = self._send(
                    images + [np.array([im.shape[:2] for im in images], np.float32)])
                det = self._infer_fixed(self.canvas_mixed(raws), orig)
            self._unpack(det, range(len(images)), results)
            return results  # type: ignore[return-value]
        for (hw, _), idxs in groups.items():
            raw, orig = self._send([[images[i] for i in idxs], np.array(hw, np.float32)])
            self._unpack(self._infer(raw, orig), idxs, results)
        return results  # type: ignore[return-value]

    def _send(self, parts: list) -> List[torch.Tensor]:
        """``parts`` (arrays, or lists of same-shaped arrays to stack) on the
        model's device: made ready on the host under span ``stack``, moved
        under ``upload``.  On a card they are written into the pinned arena
        and sent in one asynchronous copy; elsewhere each becomes a tensor
        as it is (a list stacked into a fresh array)."""
        if self._arena is None:
            with span("stack"):
                host = [torch.from_numpy(np.ascontiguousarray(p) if isinstance(p, np.ndarray)
                                         else np.stack(p)) for p in parts]
            with span("upload"):
                return [t.to(self.device) for t in host]
        with self._arena.lock:
            with span("stack"):
                self._arena.stage(parts)
            with span("upload"):
                return self._arena.upload(self.device)

    def predict(self, x: Any, image_loader: Optional[Callable] = None) -> List[Dict[str, np.ndarray]]:
        """Detect on a path, an HWC array, or a list of either."""
        return self(self.collate_images(x, image_loader or read_image))

    def predict_rich(self, x: Any, image_loader: Optional[Callable] = None):
        """``predict``, its detections wrapped in a ``DetectionResults`` (print,
        records, pandas, render, crop, save) with the images and, where
        given, the file names."""
        from yolort_tpu_torch.utils.results import DetectionResults

        files = [x] if isinstance(x, str) else (
            [s for s in x if isinstance(s, str)] if isinstance(x, (list, tuple)) else None)
        images = self.collate_images(x, image_loader or read_image)
        return DetectionResults(images, self(images), files=files or None)

    @staticmethod
    def collate_images(samples: Any, image_loader: Callable) -> List[np.ndarray]:
        """A path, an HWC array, or a list of either, as a list of HWC
        arrays: paths read by ``image_loader``, uint8 arrays kept uint8
        (normalised on the device), any other as float32 in [0, 1]."""
        if isinstance(samples, str) or (isinstance(samples, np.ndarray) and samples.ndim == 3):
            samples = [samples]
        out = []
        for s in samples:
            if isinstance(s, str):
                out.append(image_loader(s))
                continue
            arr = np.asarray(s)
            if arr.ndim != 3:
                raise ValueError(f"expected an HWC image, got shape {arr.shape}")
            out.append(arr if arr.dtype == np.uint8 else arr.astype(np.float32, copy=False))
        return out
