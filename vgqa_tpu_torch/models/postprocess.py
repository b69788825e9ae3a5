"""Prediction post-processing (counterpart of ``vgqa_tpu/models/postprocess.py``):
boxes cxcywh -> xyxy in original pixels, and the temporal span as the argmax
of the start+end log-softmax map over start < end within valid frames."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.boxes import box_cxcywh_to_xyxy

NEG = -1e32


def postprocess(
    pred_boxes: torch.Tensor,     # [V, T, 4] cxcywh in [0, 1]
    pred_sted: torch.Tensor,      # [V, T, 2] logits
    target_sizes: torch.Tensor,   # [V, 2] (h, w) original pixels
    time_mask: torch.Tensor,      # [V, T] bool
    letterbox: Optional[torch.Tensor] = None,  # [V, 4] (sx, sy, ox, oy)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (boxes_xyxy [V, T, 4], start_idx [V], end_idx [V]).

    With ``letterbox`` a normalized canvas coordinate ``n`` maps back to
    original pixels as ``(n - o) / s`` per axis, clipped to the image;
    without it, the plain ``n * size`` rescale clamped at 0."""
    boxes = box_cxcywh_to_xyxy(pred_boxes.float())
    target_sizes = target_sizes.float()
    h = target_sizes[:, 0:1]
    w = target_sizes[:, 1:2]
    upper = torch.cat([w, h, w, h], dim=-1)[:, None, :]
    if letterbox is not None:
        letterbox = letterbox.float()
        s = letterbox[:, None, [0, 1, 0, 1]]
        o = letterbox[:, None, [2, 3, 2, 3]]
        boxes = torch.minimum(((boxes - o) / s).clamp(min=0.0), upper)
    else:
        boxes = (boxes * upper).clamp(min=0.0)

    V, T, _ = pred_sted.shape
    neg = torch.tensor(NEG, device=pred_sted.device)
    sted = torch.where(time_mask[..., None], pred_sted.float(), neg)
    start_lp = torch.log_softmax(sted[..., 0], dim=-1)
    end_lp = torch.log_softmax(sted[..., 1], dim=-1)
    prob_map = start_lp[:, :, None] + end_lp[:, None, :]      # [V, Ts, Te]

    idx = torch.arange(T, device=pred_sted.device)
    valid = (idx[:, None] < idx[None, :]) & time_mask[:, :, None] & time_mask[:, None, :]
    prob_map = torch.where(valid, prob_map, neg)
    best = prob_map.reshape(V, T * T).argmax(dim=-1)
    return boxes, best // T, best % T
