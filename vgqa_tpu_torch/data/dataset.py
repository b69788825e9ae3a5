"""VidSTG dataset: per-sample clip assembly on the host (counterpart of
``vgqa_tpu/data/dataset.py``).

The reference's ``VidSTGDataset``: a random temporal clip and linspace
subsample, selective frame decode, box alignment to the GT span,
augmentation and static-shape packaging. The subject prepend and the
verb/attribute labels (which the reference resolves inside the model) are
resolved here. Frames are decoded by this module's ``read_frames``
(``video_io.read_frames``), looked up at call time, so a host without a
decoder can put ``synthetic.frame_reader`` in its place.
"""

from __future__ import annotations

import os
import random
from typing import Any, Dict, List, Optional

import numpy as np

from .annotations import load_items, load_meta
from .clip_sampling import sample_clip
from .transforms import Compose, build_transforms, resize_frames
from .video_io import read_frames


class VidSTGDataset:
    def __init__(
        self,
        cfg,
        split: str,
        transforms: Optional[Compose] = None,
        rng: Optional[random.Random] = None,
    ):
        self.cfg = cfg
        self.split = split
        self.rng = rng or random.Random(0)
        self.transforms = transforms
        self.data_dir = cfg.DATA_DIR
        self.items = load_items(self.data_dir, split)
        if cfg.DATA_TRUNK is not None:
            self.items = self.items[: int(cfg.DATA_TRUNK)]
        self.meta = load_meta(self.data_dir, split)

    def __len__(self) -> int:
        return len(self.items)

    def _load_frames(self, item: Dict[str, Any]) -> np.ndarray:
        """Selective decode + aspect-preserving short-side pre-resize to
        RESOLUTION, as float32 in [0, 1] (the reference decodes at native
        size and resizes per frame; the aspect ratio is kept, so every later
        geometric decision is the reference's)."""
        res = self.cfg.INPUT.RESOLUTION
        path = os.path.join(self.data_dir, "videos", item["vid"] + ".mp4")
        # threads=1: training clips are dense/contiguous (multi-threaded
        # slicing would re-decode the shared GOP prefix per thread) and
        # DATALOADER.NUM_WORKERS prefetch threads already fill the cores
        frames = read_frames(path, item["frame_ids"], threads=1)
        h, w = frames.shape[1:3]
        if w >= h:
            nh, nw = res, max(1, int(round(res * w / h)))
        else:
            nh, nw = max(1, int(round(res * h / w))), res
        frames = resize_frames(frames.astype(np.float32) / 255.0, nh, nw)
        return frames

    def __getitem__(self, index: int) -> Dict[str, Any]:
        base = self.items[index]
        item = sample_clip(
            base,
            self.split,
            self.cfg.INPUT.TRAIN_SAMPLE_NUM,
            self.cfg.INPUT.TEMP_CROP_PROB,
            self.rng,
        )
        actioness = np.asarray(item["actioness"])
        action_idx = np.where(actioness)[0]
        if len(action_idx) == 0:
            return self[(index + 1) % len(self.items)]

        frames = self._load_frames(item)
        t, fh, fw = frames.shape[:3]

        # align GT boxes with sampled frames, rescaled from original video pixels to the decoded resolution
        temp_gt = item["gt_temp_bound"]
        start_idx, end_idx = int(action_idx[0]), int(action_idx[-1])
        bbox_rows = [
            item["frame_ids"][i] - temp_gt[0] for i in range(start_idx, end_idx + 1)
        ]
        boxes = np.asarray(item["bboxs"])[bbox_rows].reshape(-1, 4).astype(np.float32)
        ow, oh = item["width"], item["height"]
        boxes = boxes * np.array([fw / ow, fh / oh, fw / ow, fh / oh], np.float32)
        # ori->frame affine, composed through every transform so eval can
        # invert predictions exactly back to original video pixels
        letterbox = np.array([fw / ow, fh / oh, 0.0, 0.0], np.float32)

        # subject prepend (the reference does it inside the model)
        info = self.meta.get(str(item["item_id"]), {})
        subject = info.get("sub", "")
        text = (subject + " " + item["description"]).strip().lower()

        sample = {
            "frames": frames,
            "boxes": boxes,
            "text": text,
            "actioness": actioness.astype(np.float32),
            "letterbox": letterbox,
        }
        if self.transforms is not None:
            sample = self.transforms(sample)

        sample.update(
            item_id=item["item_id"],
            vid=item["vid"],
            frame_ids=list(item["frame_ids"]),
            qtype=item.get("qtype", "none"),
            ori_size=(oh, ow),
            start_heatmap=np.asarray(item["start_heatmap"]),
            end_heatmap=np.asarray(item["end_heatmap"]),
            sted=np.array([start_idx, end_idx], np.int64),
            verb_index_list=info.get("verb_index_list", []),
            adj_index_list=info.get("adj_index_list", []),
        )
        return sample


def build_dataset(cfg, split: str, transforms=None, rng=None) -> VidSTGDataset:
    if transforms is None and split is not None:
        transforms = build_transforms(cfg, is_train=(split == "train"), rng=rng)
    return VidSTGDataset(cfg, split, transforms, rng)
