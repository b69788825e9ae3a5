"""Static-shape batch collation (counterpart of ``vgqa_tpu/data/collate.py``).

Samples are packed onto fixed ``[V, T_pad, res, res, 3]`` canvases with
explicit masks, and targets become dense per-frame tensors: the ground-truth
boxes are scattered onto their span. Everything is built in numpy and
returned as CPU torch tensors; :func:`batch_to` moves a batch to its device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from ..utils.containers import TextBatch, VideoBatch
from .tokenizer import batch_encode


def collate(
    samples: Sequence[Dict[str, Any]],
    tokenizer,
    pad_t: int,
    max_query_len: int,
    app_num: int,
    mot_num: int,
) -> Dict[str, Any]:
    """Returns {video: VideoBatch, text: TextBatch, targets: {...}, info: [...]}.
    Frames keep their dtype: uint8 canvases under ``TPU.UINT8_FEED`` (the
    train step normalizes on the device), float otherwise."""
    v = len(samples)
    res_h, res_w = samples[0]["frames"].shape[1:3]
    frames = np.zeros((v, pad_t, res_h, res_w, 3), samples[0]["frames"].dtype)
    pixel_mask = np.zeros((v, res_h, res_w), bool)
    time_mask = np.zeros((v, pad_t), bool)
    boxes = np.zeros((v, pad_t, 4), np.float32)
    actioness = np.zeros((v, pad_t), np.float32)
    sted = np.zeros((v, 2), np.int32)
    attr = np.zeros((v, app_num), np.float32)
    verb = np.zeros((v, mot_num), np.float32)
    texts: List[str] = []
    info: List[Dict[str, Any]] = []

    for i, s in enumerate(samples):
        t = s["frames"].shape[0]
        if t > pad_t:
            raise ValueError(f"collate: sample has {t} frames, more than pad_t={pad_t}")
        frames[i, :t] = s["frames"]
        pixel_mask[i] = s.get("pixel_mask", np.ones((res_h, res_w), bool))
        time_mask[i, :t] = True
        act = np.asarray(s["actioness"], np.float32)
        actioness[i, :t] = act
        span = np.where(act > 0)[0]
        if span.size == 0:
            raise ValueError(
                "collate: sample has no positive actioness frame "
                f"(vid={s.get('vid', '?')!r}, item_id={s.get('item_id', i)!r})")
        s0, s1 = int(span[0]), int(span[-1])
        sted[i] = (s0, s1)
        boxes[i, s0:s1 + 1] = np.asarray(s["boxes"], np.float32)
        for idx in s.get("adj_index_list", []):
            if 0 <= idx < app_num:
                attr[i, idx] = 1.0
        for idx in s.get("verb_index_list", []):
            if 0 <= idx < mot_num:
                verb[i, idx] = 1.0
        texts.append(s["text"])
        ori = s.get("ori_size", (res_h, res_w))
        info.append({
            "item_id": s.get("item_id", i),
            "vid": s.get("vid", ""),
            "frame_ids": s.get("frame_ids", list(range(t))),
            "qtype": s.get("qtype", "none"),
            "ori_size": ori,
            # ori-pixels -> canvas-pixels affine (sx, sy, ox, oy)
            "letterbox": ([float(x) for x in s["letterbox"]]
                          if s.get("letterbox") is not None
                          else [res_w / ori[1], res_h / ori[0], 0.0, 0.0]),
            "duration": t,
        })

    ids, tmask = batch_encode(tokenizer, texts, max_query_len)
    return {
        "video": VideoBatch(torch.from_numpy(frames), torch.from_numpy(pixel_mask),
                            torch.from_numpy(time_mask)),
        "text": TextBatch(torch.from_numpy(ids).long(), torch.from_numpy(tmask)),
        "targets": {
            "boxes": torch.from_numpy(boxes),
            "actioness": torch.from_numpy(actioness),
            "time_mask": torch.from_numpy(time_mask),
            "sted": torch.from_numpy(sted).long(),
            "attr_labels": torch.from_numpy(attr),
            "verb_labels": torch.from_numpy(verb),
        },
        "info": info,
    }


def batch_to(batch: Dict[str, Any], device) -> Dict[str, Any]:
    """Move a collated batch's tensors to ``device`` (without blocking on
    the card: pinned host tensors upload asynchronously)."""
    v, t = batch["video"], batch["text"]
    nb = device.type == "cuda"
    return {
        "video": VideoBatch(*(x.to(device, non_blocking=nb)
                              for x in (v.frames, v.pixel_mask, v.time_mask))),
        "text": TextBatch(t.token_ids.to(device, non_blocking=nb),
                          t.mask.to(device, non_blocking=nb)),
        "targets": {k: x.to(device, non_blocking=nb) for k, x in batch["targets"].items()},
    }
