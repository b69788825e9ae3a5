"""Frozen copy of the port module named below, imports made local; kernel calls go to
``plain_kernels``.

Box geometry (counterpart of ``vgqa_tpu/utils/boxes.py``): format
conversions and the paired (elementwise) IoU / GIoU of the grounding loss,
which needs no N x M matrix, and the numpy IoU matrix of the evaluator."""

from __future__ import annotations

import numpy as np
import torch


def box_cxcywh_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x_min, y_min, x_max, y_max); last dim 4."""
    cx, cy, w, h = x.unbind(-1)
    return torch.stack(
        [cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1
    )


def box_xyxy_to_cxcywh(x: torch.Tensor) -> torch.Tensor:
    x0, y0, x1, y1 = x.unbind(-1)
    return torch.stack([(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of xyxy boxes, any leading shape."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def paired_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Elementwise IoU of aligned xyxy boxes. Returns (iou, union)."""
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    tl = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    br = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (br - tl).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / union.clamp(min=1e-6), union


def paired_generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU of aligned xyxy boxes."""
    iou, union = paired_box_iou(boxes1, boxes2)
    enc_tl = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    enc_br = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    enc_wh = (enc_br - enc_tl).clamp(min=0.0)
    enc_area = enc_wh[..., 0] * enc_wh[..., 1]
    return iou - (enc_area - union) / enc_area.clamp(min=1e-6)


def np_box_area(boxes: np.ndarray) -> np.ndarray:
    """Areas of xyxy numpy boxes [N, 4]."""
    if boxes.ndim != 2 or boxes.shape[-1] != 4:
        raise ValueError(f"boxes of shape {boxes.shape}, not [N, 4]")
    return (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])


def np_box_iou(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """IoU matrix [N, M] of xyxy numpy boxes (the host-side evaluator's)."""
    area1 = np_box_area(boxes1)
    area2 = np_box_area(boxes2)
    tl = np.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    br = np.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[:, :, 0] * wh[:, :, 1]
    union = area1[:, None] + area2[None, :] - inter
    return inter / np.maximum(union, 1e-12)
