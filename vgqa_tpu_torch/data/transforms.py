"""Host-side video/box/text augmentation pipeline (counterpart of
``vgqa_tpu/data/transforms.py``: the same transforms, drawing from the same
``random.Random`` in the same order, so one seed gives the same flips,
resizes, crops and letterbox offsets in both packages).

Frames are resized with ``torch.nn.functional.interpolate`` on the host
(bilinear, half-pixel centres, no antialiasing, in float32: the sampling
of OpenCV's ``INTER_LINEAR``, which the JAX package calls, to within 1e-4;
OpenCV is not needed). The
pre-canvas pipeline (flip, resize ladder, size crop, 720 long-side cap) is
the reference's geometry; the final ``NormalizeAndPad`` scales each sample
to fit a fixed canvas and letterboxes it, so every batch has one shape. The
ori->canvas affine is tracked in ``sample["letterbox"]`` so evaluation can
map predictions back to original video pixels.

A sample dict carries:
  frames:    [T, H, W, 3] float32 in [0, 1]
  boxes:     [Tb, 4] xyxy pixel coords (aligned to GT-span frames)
  text:      str
  actioness: [T] float
  letterbox: [4] float (sx, sy, ox, oy): x_cur = x_ori * sx + ox, the
             affine from ORIGINAL video pixels to current frame pixels
             (set by the dataset's decode-time resize and kept by every
             geometric transform below)
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def resize_frames(frames: np.ndarray, h: int, w: int) -> np.ndarray:
    """[T, H, W, 3] -> [T, h, w, 3], bilinear with half-pixel centres and
    no antialiasing, with torch on the host in float32, rounded once to
    ``frames``' dtype (integers rounded and clipped). OpenCV's float32
    ``INTER_LINEAR`` agrees to within 1e-4 of the value range's unit at
    every size but an exact 2x downscale, which OpenCV turns into a 2x2 box
    average (uint8 results then part at rounding ties). The same size is
    the identity (a copy), as in OpenCV."""
    if frames.shape[1:3] == (h, w):
        return frames.copy()
    x = torch.from_numpy(np.ascontiguousarray(frames)).permute(0, 3, 1, 2)
    y = F.interpolate(x.float(), size=(h, w), mode="bilinear", align_corners=False,
                      antialias=False).permute(0, 2, 3, 1)
    if np.issubdtype(frames.dtype, np.integer):
        info = np.iinfo(frames.dtype)
        y = y.round().clamp(info.min, info.max)
    return y.numpy().astype(frames.dtype, copy=False)


def _update_letterbox(sample: Dict, sx: float, sy: float,
                      ox: float, oy: float) -> None:
    """Compose (x,y) -> (x*sx+ox, y*sy+oy) onto the tracked ori->frame
    affine, in place. No-op when the dataset didn't initialize one."""
    lb = sample.get("letterbox")
    if lb is None:
        return
    sample["letterbox"] = np.array(
        [lb[0] * sx, lb[1] * sy, lb[2] * sx + ox, lb[3] * sy + oy],
        np.float32,
    )


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, sample: Dict) -> Dict:
        for t in self.transforms:
            sample = t(sample)
        return sample


class RandomHorizontalFlip:
    """Flip frames+boxes and swap left/right words in the query."""

    def __init__(self, prob: float = 0.5, rng: Optional[random.Random] = None):
        self.prob = prob
        self.rng = rng or random

    def __call__(self, sample: Dict) -> Dict:
        if self.rng.random() < self.prob:
            frames = sample["frames"][:, :, ::-1].copy()
            w = frames.shape[2]
            boxes = sample["boxes"].copy()
            boxes[:, [0, 2]] = w - sample["boxes"][:, [2, 0]]
            text = (
                sample["text"]
                .replace("right", "*&^special^&*")
                .replace("left", "right")
                .replace("*&^special^&*", "left")
            )
            sample = {**sample, "frames": frames, "boxes": boxes, "text": text}
            _update_letterbox(sample, -1.0, 1.0, float(w), 0.0)
        return sample


class RandomSelect:
    def __init__(self, t1, t2, p: float = 0.5, rng=None):
        self.t1, self.t2, self.p = t1, t2, p
        self.rng = rng or random

    def __call__(self, sample: Dict) -> Dict:
        return self.t1(sample) if self.rng.random() < self.p else self.t2(sample)


class RandomResize:
    """Resize so the short side hits a randomly chosen target, capped by
    ``max_size`` on the long side."""

    def __init__(self, sizes, max_size: Optional[int] = None, rng=None):
        self.sizes = [sizes] if isinstance(sizes, int) else list(sizes)
        self.max_size = max_size
        self.rng = rng or random

    def get_size(self, h: int, w: int):
        size = self.rng.choice(self.sizes)
        if self.max_size is not None:
            mn, mx = float(min(h, w)), float(max(h, w))
            if mx / mn * size > self.max_size:
                size = int(round(self.max_size * mn / mx))
        if (w <= h and w == size) or (h <= w and h == size):
            return h, w
        if w < h:
            return int(size * h / w), size
        return size, int(size * w / h)

    def __call__(self, sample: Dict) -> Dict:
        t, h, w = sample["frames"].shape[:3]
        nh, nw = self.get_size(h, w)
        frames = resize_frames(sample["frames"], nh, nw)
        boxes = sample["boxes"] * np.array(
            [nw / w, nh / h, nw / w, nh / h], np.float32
        )
        sample = {**sample, "frames": frames, "boxes": boxes}
        _update_letterbox(sample, nw / w, nh / h, 0.0, 0.0)
        return sample


class RandomSizeCrop:
    """Crop retrying until no box degenerates: tw, th ~ randint(min_size,
    min(dim, max_size)), top/left uniform, 50 tries, then unchanged. The
    min()/max() juggling keeps the randint bounds valid for inputs smaller
    than ``min_size``; for larger ones they are the reference's bounds and
    draw the same sequence."""

    def __init__(self, min_size: int, max_size: int, max_try: int = 50, rng=None):
        self.min_size, self.max_size, self.max_try = min_size, max_size, max_try
        self.rng = rng or random

    def __call__(self, sample: Dict) -> Dict:
        frames, boxes = sample["frames"], sample["boxes"]
        t, h, w = frames.shape[:3]
        for _ in range(self.max_try):
            tw = self.rng.randint(min(self.min_size, w), max(min(w, self.max_size), min(self.min_size, w)))
            th = self.rng.randint(min(self.min_size, h), max(min(h, self.max_size), min(self.min_size, h)))
            top = self.rng.randint(0, h - th)
            left = self.rng.randint(0, w - tw)
            nb = boxes.copy()
            nb[:, [0, 2]] = np.clip(nb[:, [0, 2]] - left, 0, tw)
            nb[:, [1, 3]] = np.clip(nb[:, [1, 3]] - top, 0, th)
            if ((nb[:, 2] > nb[:, 0]) & (nb[:, 3] > nb[:, 1])).all():
                sample = {
                    **sample,
                    "frames": frames[:, top : top + th, left : left + tw].copy(),
                    "boxes": nb,
                }
                _update_letterbox(sample, 1.0, 1.0, -float(left), -float(top))
                return sample
        return sample


class NormalizeAndPad:
    """ImageNet-normalize, uniformly scale to fit, letterbox onto a static
    canvas, convert boxes to normalized cxcywh.

    The static-shape tail of the pipeline (the reference emits frames of
    varying size): frames larger than the canvas are uniformly downscaled
    first (crops, aspect and flip unchanged), then padded. Emits
    ``pixel_mask`` True=valid and finalizes ``letterbox``."""

    def __init__(self, mean, std, size, aug_translate: bool = False, rng=None,
                 emit_uint8: bool = False):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.ch, self.cw = (size, size) if isinstance(size, int) else tuple(size)
        self.aug_translate = aug_translate
        self.rng = rng or random
        # uint8 feed (TPU.UINT8_FEED): emit the canvas as raw uint8 pixels;
        # the train step and the eval forward normalize on the device, so
        # the upload is a quarter of the float canvas (34 MB instead of 135
        # for a 64f@420 clip). Geometry, masks and boxes are unchanged.
        self.emit_uint8 = emit_uint8

    def __call__(self, sample: Dict) -> Dict:
        frames = sample["frames"]
        boxes = sample["boxes"]
        t, h, w = frames.shape[:3]
        if h > self.ch or w > self.cw:
            s = min(self.ch / h, self.cw / w)
            nh, nw = min(self.ch, int(round(h * s))), min(self.cw, int(round(w * s)))
            frames = resize_frames(frames, nh, nw)
            boxes = boxes * np.array(
                [nw / w, nh / h, nw / w, nh / h], np.float32
            )
            _update_letterbox(sample, nw / w, nh / h, 0.0, 0.0)
            h, w = nh, nw

        dh, dw = self.ch - h, self.cw - w
        if self.aug_translate:
            top, left = self.rng.randint(0, dh), self.rng.randint(0, dw)
        else:
            top, left = round(dh / 2.0 - 0.1), round(dw / 2.0 - 0.1)

        if self.emit_uint8:
            out = np.zeros((t, self.ch, self.cw, 3), np.uint8)
            out[:, top : top + h, left : left + w] = np.clip(
                np.round(frames * 255.0), 0, 255
            ).astype(np.uint8)
        else:
            out = np.zeros((t, self.ch, self.cw, 3), np.float32)
            out[:, top : top + h, left : left + w] = (
                (frames - self.mean) / self.std
            )
        mask = np.zeros((self.ch, self.cw), bool)
        mask[top : top + h, left : left + w] = True
        _update_letterbox(sample, 1.0, 1.0, float(left), float(top))

        boxes = boxes + np.array([left, top, left, top], np.float32)
        cx = (boxes[:, 0] + boxes[:, 2]) / 2 / self.cw
        cy = (boxes[:, 1] + boxes[:, 3]) / 2 / self.ch
        bw = (boxes[:, 2] - boxes[:, 0]) / self.cw
        bh = (boxes[:, 3] - boxes[:, 1]) / self.ch
        norm_boxes = np.stack([cx, cy, bw, bh], axis=1)
        return {
            **sample,
            "frames": out,
            "pixel_mask": mask,
            "boxes": norm_boxes,  # normalized cxcywh from here on
        }


def canvas_hw(cfg) -> Tuple[int, int]:
    """The static canvas (h, w): ``INPUT.CANVAS`` or RESOLUTION square."""
    ch, cw = cfg.INPUT.CANVAS
    res = cfg.INPUT.RESOLUTION
    return (ch or res, cw or res)


def build_pre_canvas_transforms(cfg, is_train: bool, rng=None) -> List:
    """The reference-exact geometric pipeline, before the canvas step.

    The reference's pipeline: short-side candidates ``[RESOLUTION - 32*i for
    i in range(4)]`` under a 720 long-side cap (INPUT.MAX_SIZE), and the
    absolute RandomResize([400,500,600]) -> RandomSizeCrop(384,600) crop
    branch."""
    res = cfg.INPUT.RESOLUTION
    max_size = cfg.INPUT.MAX_SIZE
    if not is_train:
        return [RandomResize([res], max_size=max_size, rng=rng)]
    if cfg.INPUT.AUG_SCALE:
        # keep the candidates positive for small debug resolutions
        sizes = [s for s in (res - 32 * i for i in range(4)) if s >= 32] or [res]
    else:
        sizes = [res]
    return [
        RandomHorizontalFlip(cfg.INPUT.FLIP_PROB_TRAIN, rng=rng),
        RandomSelect(
            RandomResize(sizes, max_size=max_size, rng=rng),
            Compose(
                [
                    RandomResize([400, 500, 600], rng=rng),
                    RandomSizeCrop(384, 600, rng=rng),
                    RandomResize(sizes, max_size=max_size, rng=rng),
                ]
            ),
            rng=rng,
        ),
    ]


def build_transforms(cfg, is_train: bool, rng=None) -> Compose:
    """The reference's pre-canvas geometry + the static-canvas letterbox tail."""
    mean, std = cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD
    pre = build_pre_canvas_transforms(cfg, is_train, rng=rng)
    aug_translate = bool(is_train and cfg.INPUT.AUG_TRANSLATE)
    return Compose(
        pre + [NormalizeAndPad(mean, std, canvas_hw(cfg), aug_translate,
                               rng=rng, emit_uint8=bool(cfg.TPU.UINT8_FEED))]
    )
