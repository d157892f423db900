"""Batch assembly for fixed-shape training and evaluation batches.

Port of ``yolort_tpu/data/data_module.py`` on the port's host letterbox
(``models.transform.letterbox_numpy``: numpy, no OpenCV; equal to the JAX
package's cv2 letterbox where no resize is needed, within 2e-3 where one
is).

Batches are fixed-shape numpy arrays: images letterboxed to one canvas on
the host and targets padded per image, so every batch of an epoch has one
shape.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

from yolort_tpu_torch.models.transform import letterbox_numpy, resize_shape


class DetectionDataModule:
    def __init__(
        self,
        dataset,
        batch_size: int = 16,
        canvas_hw: Tuple[int, int] = (640, 640),
        min_size: int = 640,
        max_size: int = 640,
        max_targets_per_image: int = 64,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.canvas_hw = canvas_hw
        self.min_size = min_size
        self.max_size = max_size
        self.max_targets = max_targets_per_image
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.dataset)
        b = self.batch_size
        return n // b if self.drop_last else (n + b - 1) // b

    def _letterbox_target(self, target: Dict, orig_hw) -> Dict:
        """Transform GT boxes into canvas coordinates + normalized cxcywh."""
        h, w = int(orig_hw[0]), int(orig_hw[1])
        rh, rw = resize_shape(h, w, self.min_size, self.max_size)
        ch, cw = self.canvas_hw
        dh = int(round((ch - rh) / 2 - 0.1))
        dw = int(round((cw - rw) / 2 - 0.1))
        sy, sx = rh / h, rw / w
        boxes = target["boxes"].astype(np.float32).reshape(-1, 4).copy()
        boxes[:, 0::2] = boxes[:, 0::2] * sx + dw
        boxes[:, 1::2] = boxes[:, 1::2] * sy + dh
        cxcywh = np.stack(
            [
                (boxes[:, 0] + boxes[:, 2]) / 2 / cw,
                (boxes[:, 1] + boxes[:, 3]) / 2 / ch,
                (boxes[:, 2] - boxes[:, 0]) / cw,
                (boxes[:, 3] - boxes[:, 1]) / ch,
            ],
            axis=1,
        )
        return dict(target, boxes_canvas=boxes, boxes_cxcywh_norm=cxcywh)

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Yields device-ready batches:
        images (B,H,W,3) f32, targets (B,T,5), target_mask (B,T), plus the
        raw per-image targets for evaluation."""
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed).shuffle(order)
        b = self.batch_size
        ch, cw = self.canvas_hw
        for start in range(0, len(order), b):
            idxs = order[start : start + b]
            if len(idxs) < b and self.drop_last:
                return
            images = np.full((len(idxs), ch, cw, 3), 114.0 / 255.0, np.float32)
            tarr = np.zeros((len(idxs), self.max_targets, 5), np.float32)
            tmask = np.zeros((len(idxs), self.max_targets), bool)
            raw_targets: List[Dict] = []
            for i, di in enumerate(idxs):
                img, tgt = self.dataset[int(di)]
                images[i] = letterbox_numpy(
                    img, self.canvas_hw, self.min_size, self.max_size
                )
                tgt = self._letterbox_target(tgt, tgt["orig_size"])
                # training targets exclude crowd regions (the reference filters
                # iscrowd==0 in its training target assembly, coco.py:44); the
                # raw targets below keep them so eval can crowd-ignore.
                sel = np.flatnonzero(~tgt["iscrowd"].astype(bool)) if "iscrowd" in tgt \
                    else np.arange(len(tgt["labels"]))
                n = min(len(sel), self.max_targets)
                tarr[i, :n, 0] = tgt["labels"][sel[:n]]
                tarr[i, :n, 1:] = tgt["boxes_cxcywh_norm"][sel[:n]]
                tmask[i, :n] = True
                raw_targets.append(tgt)
            yield {
                "images": images,
                "targets": tarr,
                "target_mask": tmask,
                "raw_targets": raw_targets,
            }
