"""Temporal clip sampling (counterpart of ``vgqa_tpu/data/clip_sampling.py``,
the same ``random.Random`` draws in the same order).

The reference's make_vidstg_input_clip: a training sample optionally crops
around the ground-truth span (every GT frame kept, random context
boundaries), then linspace-subsamples to the split's frame budget (train:
TRAIN_SAMPLE_NUM, test: twice that).
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

import numpy as np


def sample_clip(
    item: Dict,
    split: str,
    train_sample_num: int,
    temp_crop_prob: float,
    rng: Optional[random.Random] = None,
) -> Dict:
    """item carries frame_ids (list), actioness, start_heatmap, end_heatmap
    (np arrays over the segment). Returns the same keys sliced/subsampled."""
    rng = rng or random
    budget = train_sample_num if split == "train" else train_sample_num * 2

    frame_ids: List[int] = list(item["frame_ids"])
    mask = np.asarray(item["actioness"]).copy()
    start_hm = np.asarray(item["start_heatmap"]).copy()
    end_hm = np.asarray(item["end_heatmap"]).copy()

    do_crop = split == "train" and rng.random() < temp_crop_prob
    if do_crop:
        action_idx = np.where(mask)[0]
        if len(action_idx) == 0:
            selected = list(range(len(frame_ids)))
        else:
            starts = [i for i in range(len(frame_ids)) if i < action_idx[0]]
            ends = [i for i in range(len(frame_ids)) if i > action_idx[-1]]
            s = rng.choice(starts) if starts else 0
            e = rng.choice(ends) if ends else len(frame_ids) - 1
            selected = list(range(s, e + 1))
    else:
        selected = list(range(len(frame_ids)))

    if len(selected) > budget:
        lin = np.linspace(0, len(selected) - 1, num=budget)
        idxs = [int(i) for i in lin]
        if len(set(idxs)) != len(idxs):
            raise ValueError(f"linspace subsample repeats frames: {idxs}")
        selected = [selected[i] for i in idxs]

    sel = np.asarray(selected)
    return {
        **item,
        "frame_ids": [frame_ids[i] for i in selected],
        "actioness": mask[sel],
        "start_heatmap": start_hm[sel],
        "end_heatmap": end_hm[sel],
    }
