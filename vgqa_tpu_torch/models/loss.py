"""VideoSTGLoss, the grounding training losses (counterpart of
``vgqa_tpu/models/loss.py``): masked and static-shape.

Targets (all ``[V, ...]`` tensors): ``boxes`` [V, T, 4] cxcywh in [0, 1],
valid where ``actioness``; ``actioness`` [V, T] 0/1; ``time_mask`` [V, T]
bool; ``sted`` [V, 2] int start/end frames; ``attr_labels`` [V, APP] and
``verb_labels`` [V, MOT] multi-hot. Every term is computed in float32.

Under data parallelism (an initialised ``torch.distributed`` group of W
processes, each with its slice of the global batch), the box count and the
valid-frame count are summed over the group, and each process divides its
own sums by ``max(count_global, 1) / W``: the gradient average over the W
processes then equals the gradient of the JAX package's loss on the whole
global batch, ``S_global / max(count_global, 1)``. (The reference's
``max(N_global / W, 1)`` differs from it when ``N_global < W``.) The mean
terms need no change: every process holds the same number of videos. With
no group, or W = 1, the counts are this process's.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ..parallel.distributed import all_reduce_, get_world_size
from ..utils.boxes import box_cxcywh_to_xyxy, paired_generalized_box_iou


def _bce_logits(logits, targets, weight=None):
    """Elementwise binary cross-entropy on logits (stable form)."""
    loss = logits.clamp(min=0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    if weight is not None:
        loss = loss * weight
    return loss


@torch.no_grad()
def _normalisers(actioness, time_mask):
    """(boxes, valid frames): each count summed over the data-parallel
    group, clamped at 1, over the world size (see the module docstring)."""
    counts = all_reduce_(torch.stack([(actioness * time_mask).sum(), time_mask.sum()]))
    counts = counts.clamp(min=1.0) / get_world_size()
    return counts[0], counts[1]


class VideoSTGLoss:
    """Callable loss bundle; ``losses`` selects the terms."""

    def __init__(self, sigma: float = 2.0, eos_coef: float = 0.1,
                 losses: Optional[List[str]] = None, use_aux_loss: bool = True):
        self.sigma = sigma
        self.eos_coef = eos_coef
        self.losses = losses or ["boxes", "sted", "logits_f_m", "logits_f_a",
                                 "logits_r_a", "logits_r_m", "actioness"]
        self.use_aux_loss = use_aux_loss

    def loss_boxes(self, outputs, targets, num_boxes, num_frames):
        """L1 + GIoU over the frames of the ground-truth span."""
        m = ((targets["actioness"] > 0) & targets["time_mask"]).float()
        pred = outputs["pred_boxes"].float()
        tgt = targets["boxes"].float()
        l1 = (pred - tgt).abs().sum(-1) * m
        giou = paired_generalized_box_iou(box_cxcywh_to_xyxy(pred), box_cxcywh_to_xyxy(tgt))
        return {"loss_bbox": l1.sum() / num_boxes,
                "loss_giou": ((1.0 - giou) * m).sum() / num_boxes}

    def loss_sted(self, outputs, targets, num_boxes, num_frames):
        """KL divergence against quantized Gaussian start/end targets."""
        sted = outputs["pred_sted"].float()                  # [V, T, 2]
        tm = targets["time_mask"]
        V, T, _ = sted.shape
        eps = 1e-6
        sted = torch.where(tm[..., None], sted, torch.full((), -1e32, device=sted.device))
        frames = torch.arange(T, dtype=torch.float32, device=sted.device)[None, :]

        def kl(pred_logits, target_center):
            dist = torch.exp(-((frames - target_center[:, None].float()) ** 2)
                             / (2 * self.sigma ** 2))
            dist = dist + eps
            dist = dist / dist.sum(-1, keepdim=True)
            prob = torch.softmax(pred_logits, dim=-1)
            return prob * torch.log((prob + eps) / dist) * tm

        loss = kl(sted[..., 0], targets["sted"][:, 0]) + kl(sted[..., 1], targets["sted"][:, 1])
        return {"loss_sted": loss.sum() / (V * T)}

    def loss_actioness(self, outputs, targets, num_boxes, num_frames):
        """Foreground-weighted BCE."""
        pred = outputs["pred_actioness"][..., 0].float()
        act = targets["actioness"].float()
        tm = targets["time_mask"].float()
        frames = torch.arange(pred.shape[1], device=pred.device)[None, :]
        inside = (frames >= targets["sted"][:, :1]) & (frames <= targets["sted"][:, 1:2])
        weight = torch.where(inside, 1.0, self.eos_coef)
        return {"loss_actioness": (_bce_logits(pred, act, weight) * tm).mean()}

    def _temporal_bce(self, logits, targets, num_frames):
        act = targets["actioness"].float()
        tm = targets["time_mask"].float()
        loss = _bce_logits(logits.float(), act) * tm
        return loss.sum() / num_frames

    def loss_logits_f_m(self, outputs, targets, num_boxes, num_frames):
        return {"logits_f_m": self._temporal_bce(outputs["logits_f_m"], targets, num_frames)}

    def loss_logits_f_a(self, outputs, targets, num_boxes, num_frames):
        return {"logits_f_a": self._temporal_bce(outputs["logits_f_a"], targets, num_frames)}

    def loss_logits_r_a(self, outputs, targets, num_boxes, num_frames):
        return {"logits_r_a": _bce_logits(outputs["logits_r_a"].float(),
                                          targets["attr_labels"].float()).mean()}

    def loss_logits_r_m(self, outputs, targets, num_boxes, num_frames):
        return {"logits_r_m": _bce_logits(outputs["logits_r_m"].float(),
                                          targets["verb_labels"].float()).mean()}

    def __call__(self, outputs: Dict, targets: Dict) -> Dict[str, torch.Tensor]:
        num_boxes, num_frames = _normalisers(targets["actioness"].float(),
                                             targets["time_mask"].float())
        term_map = {
            "boxes": self.loss_boxes,
            "sted": self.loss_sted,
            "actioness": self.loss_actioness,
            "logits_f_m": self.loss_logits_f_m,
            "logits_f_a": self.loss_logits_f_a,
            "logits_r_a": self.loss_logits_r_a,
            "logits_r_m": self.loss_logits_r_m,
        }
        losses: Dict[str, torch.Tensor] = {}
        for name in self.losses:
            losses.update(term_map[name](outputs, targets, num_boxes, num_frames))
        if self.use_aux_loss and "aux_outputs" in outputs:
            for i, aux in enumerate(outputs["aux_outputs"]):
                # the logits_* heads are not per decoder layer
                for name in self.losses:
                    if name.startswith("logits"):
                        continue
                    for k, v in term_map[name](aux, targets, num_boxes, num_frames).items():
                        losses[f"{k}_{i}"] = v
        return losses


def build_weight_dict(cfg) -> Dict[str, float]:
    """Loss weights by term name, aux terms included."""
    s = cfg.SOLVER
    wd = {
        "loss_bbox": s.BBOX_COEF,
        "loss_giou": s.GIOU_COEF,
        "loss_sted": s.TEMP_COEF,
        "logits_f_m": s.CONF_COEF,
        "logits_f_a": s.CONF2_COEF,
        "logits_r_a": s.CONF3_COEF,
        "logits_r_m": s.CONF4_COEF,
    }
    if cfg.MODEL.VSTG.USE_ACTION:
        wd["loss_actioness"] = s.ACTIONESS_COEF
    if s.USE_AUX_LOSS:
        aux = {}
        for i in range(cfg.MODEL.VSTG.DEC_LAYERS - 1):
            aux.update({f"{k}_{i}": v for k, v in wd.items()})
        wd.update(aux)
    return wd


def build_loss(cfg) -> VideoSTGLoss:
    """The loss bundle of ``vgqa_tpu.models.build_model``."""
    losses = ["boxes", "sted", "logits_f_m", "logits_f_a", "logits_r_a", "logits_r_m"]
    if cfg.MODEL.VSTG.USE_ACTION:
        losses.append("actioness")
    return VideoSTGLoss(sigma=cfg.SOLVER.SIGMA, eos_coef=cfg.SOLVER.EOS_COEF,
                        losses=losses, use_aux_loss=cfg.SOLVER.USE_AUX_LOSS)
