"""The fixed synthetic training sample of ``tools/bench_train.py``, made
through :func:`collate` from a numpy seed.

One video of ``INPUT.TRAIN_SAMPLE_NUM`` frames at ``INPUT.RESOLUTION``
(uint8 under ``TPU.UINT8_FEED``, else normalized floats), a query padded to
``INPUT.MAX_QUERY_LEN``, the ground-truth span over frames [T/4, max(T/2,
T/4 + 2)) with one box (cx, cy, w, h) = (0.5, 0.5, 0.2, 0.3), and no
attribute or verb labels.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from .collate import collate
from .tokenizer import build_tokenizer

QUERY = "the person in red walks to the car"


def synthetic_sample(cfg, seed: int = 0) -> Dict[str, Any]:
    t, res = cfg.INPUT.TRAIN_SAMPLE_NUM, cfg.INPUT.RESOLUTION
    rng = np.random.RandomState(seed)
    if cfg.TPU.UINT8_FEED:
        frames = rng.randint(0, 256, (t, res, res, 3)).astype(np.uint8)
    else:
        frames = (rng.randn(t, res, res, 3) * 0.1).astype(np.float32)
    s0, s1 = t // 4, max(t // 2, t // 4 + 2)
    act = np.zeros((t,), np.float32)
    act[s0:s1] = 1.0
    return {"frames": frames, "actioness": act,
            "boxes": np.tile(np.float32([0.5, 0.5, 0.2, 0.3]), (s1 - s0, 1)),
            "text": QUERY, "vid": "synthetic", "item_id": 0}


def synthetic_batch(cfg, seed: int = 0) -> Dict[str, Any]:
    """The collated batch of one synthetic sample (V = 1, as bench_train)."""
    tok = build_tokenizer(cfg.MODEL.TEXT_MODEL.VOCAB_DIR)
    return collate([synthetic_sample(cfg, seed)], tok, cfg.INPUT.TRAIN_SAMPLE_NUM, cfg.INPUT.MAX_QUERY_LEN,
                   cfg.DATASET.APP_NUM, cfg.DATASET.MOT_NUM)
