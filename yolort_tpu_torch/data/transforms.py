"""Host-side data augmentation for detection training.

Capability parity with the reference's two augmentation stacks:
the SSD-style torchvision transforms (yolort/data/transforms.py:21-335) and
the YOLOv5 augmentations (v5/utils/augmentations.py: augment_hsv:53,
random_perspective:141, mixup:307).  Implemented fresh in numpy/cv2; these
run on the host feeding the fixed-shape device pipeline.

Port of ``yolort_tpu/data/transforms.py`` (numpy; cv2 imported by the
HSV and affine transforms when they run).

All transforms are callables ``(image, target) -> (image, target)`` over
HWC-RGB float [0,1] images and COCO-style targets ({'boxes' xyxy,'labels'}).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, target):
        for t in self.transforms:
            img, target = t(img, target)
        return img, target


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5, seed: Optional[int] = None):
        self.p = p
        self.rng = np.random.default_rng(seed)

    def __call__(self, img, target):
        if self.rng.random() < self.p:
            img = img[:, ::-1].copy()
            w = img.shape[1]
            boxes = target["boxes"].copy()
            boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
            target = dict(target, boxes=boxes)
        return img, target


class RandomHSV:
    """YOLOv5 HSV color jitter (augmentations.py:53)."""

    def __init__(self, h_gain=0.015, s_gain=0.7, v_gain=0.4, seed: Optional[int] = None):
        self.gains = (h_gain, s_gain, v_gain)
        self.rng = np.random.default_rng(seed)

    def __call__(self, img, target):
        import cv2

        r = self.rng.uniform(-1, 1, 3) * np.asarray(self.gains) + 1
        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        hsv = cv2.cvtColor(u8, cv2.COLOR_RGB2HSV)
        h, s, v = cv2.split(hsv)
        lut_h = ((np.arange(256) * r[0]) % 180).astype(np.uint8)
        lut_s = np.clip(np.arange(256) * r[1], 0, 255).astype(np.uint8)
        lut_v = np.clip(np.arange(256) * r[2], 0, 255).astype(np.uint8)
        hsv = cv2.merge((cv2.LUT(h, lut_h), cv2.LUT(s, lut_s), cv2.LUT(v, lut_v)))
        out = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32) / 255.0
        return out, target


class RandomZoomOut:
    """Place the image on a larger fill canvas (data/transforms.py:209)."""

    def __init__(self, max_scale: float = 4.0, fill: float = 114.0 / 255.0,
                 p: float = 0.5, seed: Optional[int] = None):
        self.max_scale = max_scale
        self.fill = fill
        self.p = p
        self.rng = np.random.default_rng(seed)

    def __call__(self, img, target):
        if self.rng.random() >= self.p:
            return img, target
        h, w = img.shape[:2]
        scale = self.rng.uniform(1.0, self.max_scale)
        nh, nw = int(h * scale), int(w * scale)
        top = int(self.rng.uniform(0, nh - h))
        left = int(self.rng.uniform(0, nw - w))
        canvas = np.full((nh, nw, img.shape[2]), self.fill, img.dtype)
        canvas[top : top + h, left : left + w] = img
        boxes = target["boxes"].copy()
        boxes[:, [0, 2]] += left
        boxes[:, [1, 3]] += top
        return canvas, dict(target, boxes=boxes, orig_size=np.asarray([nh, nw]))


class RandomScaleTranslate:
    """Affine scale+translate keeping boxes (the non-rotational core of
    v5 random_perspective, augmentations.py:141)."""

    def __init__(self, scale: Tuple[float, float] = (0.5, 1.5), translate: float = 0.1,
                 fill: float = 114.0 / 255.0, min_box: float = 2.0,
                 seed: Optional[int] = None):
        self.scale = scale
        self.translate = translate
        self.fill = fill
        self.min_box = min_box
        self.rng = np.random.default_rng(seed)

    def __call__(self, img, target):
        import cv2

        h, w = img.shape[:2]
        s = self.rng.uniform(*self.scale)
        tx = self.rng.uniform(0.5 - self.translate, 0.5 + self.translate) * w - s * w / 2
        ty = self.rng.uniform(0.5 - self.translate, 0.5 + self.translate) * h - s * h / 2
        m = np.asarray([[s, 0, tx], [0, s, ty]], np.float32)
        out = cv2.warpAffine(img, m, (w, h), borderValue=(self.fill,) * 3)
        boxes = target["boxes"].copy()
        if len(boxes):
            boxes[:, [0, 2]] = boxes[:, [0, 2]] * s + tx
            boxes[:, [1, 3]] = boxes[:, [1, 3]] * s + ty
            boxes[:, [0, 2]] = boxes[:, [0, 2]].clip(0, w)
            boxes[:, [1, 3]] = boxes[:, [1, 3]].clip(0, h)
            keep = ((boxes[:, 2] - boxes[:, 0]) > self.min_box) & (
                (boxes[:, 3] - boxes[:, 1]) > self.min_box
            )
            target = dict(
                target,
                boxes=boxes[keep],
                labels=target["labels"][keep],
            )
            for k in ("area", "iscrowd"):
                if k in target and len(target[k]) == len(keep):
                    target[k] = target[k][keep]
        return out, target


def bbox_ioa(box: np.ndarray, boxes: np.ndarray, eps: float = 1e-7) -> np.ndarray:
    """Intersection of ``box`` (4,) with each of ``boxes`` (N,4), over the
    area of ``boxes`` (reference v5/utils/metrics.py bbox_ioa:304)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    ix = np.clip(np.minimum(box[2], boxes[:, 2]) - np.maximum(box[0], boxes[:, 0]), 0, None)
    iy = np.clip(np.minimum(box[3], boxes[:, 3]) - np.maximum(box[1], boxes[:, 1]), 0, None)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) + eps
    return ix * iy / area


def box_candidates(box1, box2, wh_thr=2.0, ar_thr=20.0, area_thr=0.1, eps=1e-16):
    """Keep boxes that survived an augmentation: box1 (4,N) before, box2
    (4,N) after (reference v5/utils/augmentations.py:316)."""
    w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
    w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    ar = np.maximum(w2 / (h2 + eps), h2 / (w2 + eps))
    return (w2 > wh_thr) & (h2 > wh_thr) & (w2 * h2 / (w1 * h1 + eps) > area_thr) & (ar < ar_thr)


def _filter_target(target: Dict, keep: np.ndarray, new_boxes: np.ndarray) -> Dict:
    out = dict(target, boxes=new_boxes[keep], labels=target["labels"][keep])
    for k in ("area", "iscrowd"):
        if k in target and len(target[k]) == len(keep):
            out[k] = target[k][keep]
    return out


class RandomPerspective:
    """Full YOLOv5 geometric augmentation: center -> perspective -> rotation/
    scale -> shear -> translate, composed right-to-left, with the
    box_candidates survival filter (reference v5/utils/augmentations.py:141-246)."""

    def __init__(self, degrees: float = 0.0, translate: float = 0.1, scale: float = 0.5,
                 shear: float = 0.0, perspective: float = 0.0,
                 fill: float = 114.0 / 255.0, seed: Optional[int] = None):
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.shear = shear
        self.perspective = perspective
        self.fill = fill
        self.rng = np.random.default_rng(seed)

    def __call__(self, img, target):
        import math

        import cv2

        h, w = img.shape[:2]
        rng = self.rng

        C = np.eye(3)
        C[0, 2] = -w / 2
        C[1, 2] = -h / 2
        P = np.eye(3)
        P[2, 0] = rng.uniform(-self.perspective, self.perspective)
        P[2, 1] = rng.uniform(-self.perspective, self.perspective)
        R = np.eye(3)
        a = rng.uniform(-self.degrees, self.degrees)
        s = rng.uniform(1 - self.scale, 1 + self.scale)
        R[:2] = cv2.getRotationMatrix2D(angle=a, center=(0, 0), scale=s)
        S = np.eye(3)
        S[0, 1] = math.tan(rng.uniform(-self.shear, self.shear) * math.pi / 180)
        S[1, 0] = math.tan(rng.uniform(-self.shear, self.shear) * math.pi / 180)
        T = np.eye(3)
        T[0, 2] = rng.uniform(0.5 - self.translate, 0.5 + self.translate) * w
        T[1, 2] = rng.uniform(0.5 - self.translate, 0.5 + self.translate) * h
        M = T @ S @ R @ P @ C

        if self.perspective:
            out = cv2.warpPerspective(img, M, dsize=(w, h), borderValue=(self.fill,) * 3)
        else:
            out = cv2.warpAffine(img, M[:2], dsize=(w, h), borderValue=(self.fill,) * 3)

        boxes = np.asarray(target["boxes"], np.float32).reshape(-1, 4)
        n = len(boxes)
        if n:
            # warp all 4 corners, re-box as the axis-aligned hull
            xy = np.ones((n * 4, 3))
            xy[:, :2] = boxes[:, [0, 1, 2, 3, 0, 3, 2, 1]].reshape(n * 4, 2)
            xy = xy @ M.T
            xy = (xy[:, :2] / xy[:, 2:3] if self.perspective else xy[:, :2]).reshape(n, 8)
            x = xy[:, [0, 2, 4, 6]]
            y = xy[:, [1, 3, 5, 7]]
            new = np.stack([x.min(1), y.min(1), x.max(1), y.max(1)], axis=1)
            new[:, [0, 2]] = new[:, [0, 2]].clip(0, w)
            new[:, [1, 3]] = new[:, [1, 3]].clip(0, h)
            keep = box_candidates(boxes.T * s, new.T, area_thr=0.10)
            target = _filter_target(target, keep, new)
        return out, target


class RandomVerticalFlip:
    """flipud (reference hyp key 'flipud')."""

    def __init__(self, p: float = 0.0, seed: Optional[int] = None):
        self.p = p
        self.rng = np.random.default_rng(seed)

    def __call__(self, img, target):
        if self.p and self.rng.random() < self.p:
            img = img[::-1].copy()
            h = img.shape[0]
            boxes = target["boxes"].copy()
            boxes[:, [1, 3]] = h - boxes[:, [3, 1]]
            target = dict(target, boxes=boxes)
        return img, target


class CopyPaste:
    """Copy-Paste augmentation (https://arxiv.org/abs/2012.07177; reference
    v5/utils/augmentations.py:248).  The reference pastes *segment* masks
    from the horizontally-flipped image; this pipeline carries boxes only, so
    the axis-aligned box region is pasted instead — same placement rule
    (mirror box, accept when IoA with every existing label < 0.30)."""

    def __init__(self, p: float = 0.5, seed: Optional[int] = None):
        self.p = p
        self.rng = np.random.default_rng(seed)

    def __call__(self, img, target):
        boxes = np.asarray(target["boxes"], np.float32).reshape(-1, 4)
        n = len(boxes)
        if not self.p or not n:
            return img, target
        h, w = img.shape[:2]
        flipped = img[:, ::-1]
        out = img.copy()
        new_boxes = [boxes]
        new_labels = [np.asarray(target["labels"])]
        k = max(1, round(self.p * n))
        for j in self.rng.permutation(n)[:k]:
            x1, y1, x2, y2 = boxes[j]
            box = np.asarray([w - x2, y1, w - x1, y2], np.float32)
            if (bbox_ioa(box, np.concatenate(new_boxes)) < 0.30).all():
                xi1, yi1, xi2, yi2 = (int(round(v)) for v in box)
                xi1, xi2 = max(xi1, 0), min(xi2, w)
                yi1, yi2 = max(yi1, 0), min(yi2, h)
                if xi2 > xi1 and yi2 > yi1:
                    out[yi1:yi2, xi1:xi2] = flipped[yi1:yi2, xi1:xi2]
                    new_boxes.append(box[None])
                    new_labels.append(np.asarray(target["labels"])[j : j + 1])
        boxes_out = np.concatenate(new_boxes)
        labels_out = np.concatenate(new_labels)
        tgt = dict(target, boxes=boxes_out, labels=labels_out)
        # pasted instances get fresh area/iscrowd rows
        n_new = len(boxes_out) - n
        if n_new and "area" in tgt and len(target.get("area", ())) == n:
            wh = boxes_out[n:, 2:] - boxes_out[n:, :2]
            tgt["area"] = np.concatenate([target["area"], (wh[:, 0] * wh[:, 1])])
        if n_new and "iscrowd" in tgt and len(target.get("iscrowd", ())) == n:
            tgt["iscrowd"] = np.concatenate(
                [target["iscrowd"], np.zeros(n_new, target["iscrowd"].dtype)]
            )
        return out, tgt


class Cutout:
    """Cutout augmentation (https://arxiv.org/abs/1708.04552; reference
    v5/utils/augmentations.py:279): a pyramid of random gray patches, with
    labels >60% obscured by a large patch removed."""

    SCALES = [0.5] * 1 + [0.25] * 2 + [0.125] * 4 + [0.0625] * 8 + [0.03125] * 16

    def __init__(self, p: float = 0.5, seed: Optional[int] = None):
        self.p = p
        self.rng = np.random.default_rng(seed)

    def __call__(self, img, target):
        if not self.p or self.rng.random() >= self.p:
            return img, target
        h, w = img.shape[:2]
        img = img.copy()
        boxes = np.asarray(target["boxes"], np.float32).reshape(-1, 4)
        labels_keep = np.ones(len(boxes), bool)
        rng = self.rng
        for s in self.SCALES:
            mask_h = int(rng.integers(1, max(int(h * s), 2)))
            mask_w = int(rng.integers(1, max(int(w * s), 2)))
            xmin = max(0, int(rng.integers(0, w + 1)) - mask_w // 2)
            ymin = max(0, int(rng.integers(0, h + 1)) - mask_h // 2)
            xmax = min(w, xmin + mask_w)
            ymax = min(h, ymin + mask_h)
            img[ymin:ymax, xmin:xmax] = rng.integers(64, 192, 3) / 255.0
            if len(boxes) and s > 0.03:
                patch = np.asarray([xmin, ymin, xmax, ymax], np.float32)
                labels_keep &= bbox_ioa(patch, boxes) < 0.60
        if len(boxes):
            target = _filter_target(target, labels_keep, boxes)
        return img, target


class RandomIoUCrop:
    """SSD-style IoU-constrained crop (reference yolort/data/transforms.py:114,
    after the ssd_coco Caffe sampler): sample a min-jaccard option, then try
    crops until at least one box center lies inside and the max box-crop IoU
    clears the option; keep center-inside boxes, shifted and clipped."""

    def __init__(self, min_scale=0.3, max_scale=1.0, min_aspect_ratio=0.5,
                 max_aspect_ratio=2.0, sampler_options=None, trials: int = 40,
                 seed: Optional[int] = None):
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.min_ar = min_aspect_ratio
        self.max_ar = max_aspect_ratio
        self.options = sampler_options or [0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0]
        self.trials = trials
        self.rng = np.random.default_rng(seed)

    def __call__(self, img, target):
        boxes = np.asarray(target["boxes"], np.float32).reshape(-1, 4)
        if not len(boxes):
            return img, target
        h, w = img.shape[:2]
        rng = self.rng
        while True:
            min_jaccard = self.options[int(rng.integers(0, len(self.options)))]
            if min_jaccard >= 1.0:  # leave-as-is option
                return img, target
            for _ in range(self.trials):
                r = self.min_scale + (self.max_scale - self.min_scale) * rng.random(2)
                new_w, new_h = int(w * r[0]), int(h * r[1])
                if new_h == 0 or not (self.min_ar <= new_w / new_h <= self.max_ar):
                    continue
                r = rng.random(2)
                left = int((w - new_w) * r[0])
                top = int((h - new_h) * r[1])
                right, bottom = left + new_w, top + new_h
                if left == right or top == bottom:
                    continue
                cx = 0.5 * (boxes[:, 0] + boxes[:, 2])
                cy = 0.5 * (boxes[:, 1] + boxes[:, 3])
                inside = (left < cx) & (cx < right) & (top < cy) & (cy < bottom)
                if not inside.any():
                    continue
                sel = boxes[inside]
                crop = np.asarray([left, top, right, bottom], np.float32)
                ix = np.clip(np.minimum(sel[:, 2], crop[2]) - np.maximum(sel[:, 0], crop[0]), 0, None)
                iy = np.clip(np.minimum(sel[:, 3], crop[3]) - np.maximum(sel[:, 1], crop[1]), 0, None)
                inter = ix * iy
                area_b = (sel[:, 2] - sel[:, 0]) * (sel[:, 3] - sel[:, 1])
                area_c = float(new_w * new_h)
                iou = inter / (area_b + area_c - inter)
                if iou.max() < min_jaccard:
                    continue
                new = sel.copy()
                new[:, 0::2] = (new[:, 0::2] - left).clip(0, new_w)
                new[:, 1::2] = (new[:, 1::2] - top).clip(0, new_h)
                tgt = _filter_target(target, inside, boxes)
                tgt["boxes"] = new
                tgt["orig_size"] = np.asarray([new_h, new_w])
                return img[top:bottom, left:right].copy(), tgt


class RandomPhotometricDistort:
    """SSD-style photometric jitter (reference yolort/data/transforms.py:276):
    brightness/contrast/saturation/hue each with prob p, contrast randomly
    ordered before or after, plus a channel permutation."""

    def __init__(self, contrast=(0.5, 1.5), saturation=(0.5, 1.5), hue=(-0.05, 0.05),
                 brightness=(0.875, 1.125), p: float = 0.5, seed: Optional[int] = None):
        self.contrast = contrast
        self.saturation = saturation
        self.hue = hue
        self.brightness = brightness
        self.p = p
        self.rng = np.random.default_rng(seed)

    def _saturate(self, img, factor):
        gray = img @ np.asarray([0.299, 0.587, 0.114], np.float32)
        return gray[..., None] + (img - gray[..., None]) * factor

    def _hue_shift(self, img, shift):
        import cv2

        u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
        hsv = cv2.cvtColor(u8, cv2.COLOR_RGB2HSV)
        hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(shift * 180)) % 180
        return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).astype(np.float32) / 255.0

    def __call__(self, img, target):
        rng = self.rng
        r = rng.random(7)
        if r[0] < self.p:
            img = img * rng.uniform(*self.brightness)
        contrast_before = r[1] < 0.5
        if contrast_before and r[2] < self.p:
            mean = img.mean()
            img = mean + (img - mean) * rng.uniform(*self.contrast)
        if r[3] < self.p:
            img = self._saturate(img, rng.uniform(*self.saturation))
        if r[4] < self.p:
            img = self._hue_shift(img, rng.uniform(*self.hue))
        if not contrast_before and r[5] < self.p:
            mean = img.mean()
            img = mean + (img - mean) * rng.uniform(*self.contrast)
        if r[6] < self.p:
            img = img[..., rng.permutation(3)]
        return np.clip(img, 0, 1).astype(np.float32), target


class Mixup:
    """Blend two samples (augmentations.py:307). Apply at the batch level."""

    def __init__(self, beta: float = 32.0, seed: Optional[int] = None):
        self.beta = beta
        self.rng = np.random.default_rng(seed)

    def __call__(self, sample_a, sample_b):
        img_a, tgt_a = sample_a
        img_b, tgt_b = sample_b
        if img_a.shape != img_b.shape:
            return sample_a
        lam = self.rng.beta(self.beta, self.beta)
        img = img_a * lam + img_b * (1 - lam)
        tgt = dict(
            tgt_a,
            boxes=np.concatenate([tgt_a["boxes"], tgt_b["boxes"]]),
            labels=np.concatenate([tgt_a["labels"], tgt_b["labels"]]),
        )
        return img.astype(np.float32), tgt


def default_train_transforms(seed: Optional[int] = None, hyp: Optional[Dict] = None) -> Compose:
    """YOLOv5-style training augmentation stack.  With a hyp dict
    (trainer.hyp schema) every knob is hyp-driven, mirroring how the
    reference's dataloader consumes hyp.scratch.yaml
    (v5/utils/augmentations.py + datasets)."""
    if hyp is None:
        return Compose(
            [
                RandomScaleTranslate(seed=seed),
                RandomHSV(seed=seed),
                RandomHorizontalFlip(seed=seed),
            ]
        )
    ts = [
        RandomPerspective(
            degrees=hyp.get("degrees", 0.0),
            translate=hyp.get("translate", 0.1),
            scale=hyp.get("scale", 0.5),
            shear=hyp.get("shear", 0.0),
            perspective=hyp.get("perspective", 0.0),
            seed=seed,
        ),
        RandomHSV(hyp.get("hsv_h", 0.015), hyp.get("hsv_s", 0.7), hyp.get("hsv_v", 0.4),
                  seed=seed),
        RandomVerticalFlip(hyp.get("flipud", 0.0), seed=seed),
        RandomHorizontalFlip(hyp.get("fliplr", 0.5), seed=seed),
    ]
    if hyp.get("copy_paste", 0.0) > 0:
        ts.insert(0, CopyPaste(hyp["copy_paste"], seed=seed))
    if hyp.get("cutout", 0.0) > 0:
        ts.append(Cutout(hyp["cutout"], seed=seed))
    return Compose(ts)


def ssd_style_train_transforms(seed: Optional[int] = None) -> Compose:
    """The reference's SSD-style default_train_transforms
    (yolort/data/transforms.py:21-33: PhotometricDistort + ZoomOut +
    IoUCrop + HFlip)."""
    return Compose(
        [
            RandomPhotometricDistort(seed=seed),
            RandomZoomOut(seed=seed),
            RandomIoUCrop(seed=seed),
            RandomHorizontalFlip(seed=seed),
        ]
    )


def default_val_transforms() -> Compose:
    return Compose([])
