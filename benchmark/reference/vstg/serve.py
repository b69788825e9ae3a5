"""The reference's grounding answer for one request, as the served path
defines it: 2T uint8 frames split into their even and odd halves (V = 2),
normalized in float32, the query tokenized once per half, one forward of
the model, the post-process into per-frame boxes in original pixels and a
start/end pair per half, and the merge of the halves (boxes by linear
interpolation, scores by hold interpolation, the span by union)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .containers import TextBatch, VideoBatch
from .postprocess import postprocess
from .tokenizer import HashTokenizer, batch_encode

PIXEL_MEAN = (0.485, 0.456, 0.406)
PIXEL_STD = (0.229, 0.224, 0.225)


def _interp_boxes(d):
    fids = sorted(d)
    for left, right in zip(fids[:-1], fids[1:]):
        if right - left > 1:
            lb, rb = np.asarray(d[left], np.float64), np.asarray(d[right], np.float64)
            for s in range(1, right - left):
                d[left + s] = (lb + s * (rb - lb) / (right - left)).tolist()
    return {f: d[f] for f in sorted(d)}


def _interp_hold(d):
    fids = sorted(d)
    for left, right in zip(fids[:-1], fids[1:]):
        n = right - left
        for s in range(1, n):
            d[left + s] = d[left] if s <= n // 2 else d[right]
    return {f: d[f] for f in sorted(d)}


@torch.no_grad()
def ground(model, frames: torch.Tensor, fps: float, ori_size, query: str,
           max_query_len: int, pixel_mean=PIXEL_MEAN, pixel_std=PIXEL_STD,
           tokenizer=None) -> Dict[str, Any]:
    """``frames`` uint8 [2T, S, S, 3] on the model's device. Returns the
    response dict and, under ``"halves"``, each half's start/end log-prob
    map and chosen pair."""
    dev = frames.device
    t2, res = frames.shape[0], frames.shape[1]
    if t2 % 2:
        frames = torch.cat([frames, frames[-1:]], 0)
        t2 += 1
    halves = torch.stack([frames[0::2], frames[1::2]])            # [2, T, S, S, 3]
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=dev)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=dev)
    x = (halves.float() / 255.0 - mean) / std
    T = t2 // 2
    video = VideoBatch(x, torch.ones((2, res, res), dtype=torch.bool, device=dev),
                       torch.ones((2, T), dtype=torch.bool, device=dev))
    ids, mask = batch_encode(tokenizer or HashTokenizer(), [query, query], max_query_len)
    text = TextBatch(torch.from_numpy(ids).long().to(dev), torch.from_numpy(mask).to(dev))
    h, w = ori_size
    ori = torch.tensor([[h, w], [h, w]], dtype=torch.float32, device=dev)
    lb = torch.tensor([[res / w / res, res / h / res, 0.0, 0.0]] * 2, dtype=torch.float32,
                      device=dev)
    out = model(video, text)
    boxes, s_idx, e_idx = postprocess(out["pred_boxes"], out["pred_sted"], ori,
                                      video.time_mask, letterbox=lb)
    boxes = boxes.float().cpu().numpy()
    att = out["att_sequences"].float().cpu().numpy()
    s_idx, e_idx = s_idx.cpu().numpy(), e_idx.cpu().numpy()
    fids = [list(range(half, t2, 2)) for half in (0, 1)]
    bbox, conf = {}, {}
    for half in (0, 1):
        for t in range(T):
            bbox[fids[half][t]] = [float(v) for v in boxes[half, t]]
            conf[fids[half][t]] = float(att[half, t])
    bbox, conf = _interp_boxes(bbox), _interp_hold(conf)
    start = min(fids[0][int(s_idx[0])], fids[1][int(s_idx[1])])
    end = max(fids[0][int(e_idx[0])] + 1, fids[1][int(e_idx[1])] + 1)
    temporal = {"start": float(start) / max(fps, 1e-6), "end": float(end) / max(fps, 1e-6),
                "score": 1.0}
    tube = [{"frame": int(f), "bbox": bbox[f], "score": conf[f]} for f in sorted(bbox)]
    return {"temporal": temporal, "tube": tube, "deficits": _deficits(out["pred_sted"])}


def _deficits(pred_sted: torch.Tensor) -> np.ndarray:
    """[V, T, T]: how far each (start, end) pair's log-probability lies
    below the best pair's (inf where end <= start), as the post-process
    scores the pairs."""
    lp_s = torch.log_softmax(pred_sted[..., 0].float(), -1)
    lp_e = torch.log_softmax(pred_sted[..., 1].float(), -1)
    m = lp_s[:, :, None] + lp_e[:, None, :]
    T = m.shape[1]
    idx = torch.arange(T, device=m.device)
    m = torch.where(idx[:, None] < idx[None, :], m, float("-inf"))
    best = m.reshape(m.shape[0], -1).max(-1).values
    return (best[:, None, None] - m).cpu().numpy()


def span_deficit(deficits: np.ndarray, start: int, end: int) -> float:
    """The least, over the per-half (start, end) pairs whose union is the
    served span [start, end) in frames (half 0 holds the even frames, half 1
    the odd), of the larger of the two halves' deficits: how far the served
    span lies below the reference's best."""
    T = deficits.shape[1]
    t = np.arange(T)
    s_pairs = [(a, b) for a in t for b in t if min(2 * a, 2 * b + 1) == start]
    e_pairs = [(a, b) for a in t for b in t if max(2 * a + 1, 2 * b + 2) == end]
    best = float("inf")
    for s0, s1 in s_pairs:
        for e0, e1 in e_pairs:
            best = min(best, max(deficits[0, s0, e0], deficits[1, s1, e1]))
    return best
