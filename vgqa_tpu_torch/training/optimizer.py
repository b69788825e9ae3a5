"""Optimizer: per-module learning-rate groups, the functional schedule, the
global-norm clip and EMA (counterpart of ``vgqa_tpu/training/optimizer.py``).

Parameters get one of the JAX package's labels from their name (the port
keeps the flax names, so the same rules apply): ``vid``/``vid_stub`` ->
frozen (Swin, when frozen), ``vis_encoder`` -> ``vis`` except the stem,
``layer1`` and every FrozenAffine (frozen), ``text_encoder`` -> ``text``
(or frozen), ``ground_decoder.time_decoder`` -> ``temp``, ``*_clas`` ->
``clas``, else ``rest``. Frozen parameters get ``requires_grad = False``
and are never updated (optax's ``set_to_zero``); the others follow
``optax.adamw`` per group (b1 0.9, b2 0.999, eps 1e-8, decoupled weight
decay on every leaf of the group), each group with its own schedule, after
``optax.clip_by_global_norm`` over the trainable leaves only, with optax's
scale ``max_norm / max(norm, max_norm)`` (not ``clip_grad_norm_``'s
``+ 1e-6``). A trainable parameter without a gradient (one whose output the
forward does not use) counts as a zero gradient, as in JAX: its moments
decay and weight decay still applies.

Only the per-leaf norm of the clip is ported: the JAX package's ``flat``
and ``bucket`` variants behind ``VGQA_CLIP_IMPL`` were measured on its TPU
as no win. Only ``SOLVER.OPTIMIZER = "adamw"`` (the default) is ported.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Tuple

import torch
from torch import nn

GROUPS = ("rest", "vis", "text", "temp", "clas", "frozen")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def label_params(names: Iterable[str], freeze_swin: bool = True,
                 freeze_text: bool = False) -> Dict[str, str]:
    """Group label of each parameter name (``model.named_parameters()``)."""

    def label_one(name: str) -> str:
        keys = name.split(".")
        top = keys[0]
        if top in ("vid", "vid_stub"):
            return "frozen" if freeze_swin else "rest"
        if top == "vis_encoder":
            # stem + layer1 always frozen; FrozenBN affines always frozen
            if keys[1] in ("conv1", "bn1"):
                return "frozen"
            if any(k.startswith("layer1_") for k in keys):
                return "frozen"
            if any(k.startswith("bn") or k == "downsample_bn" for k in keys):
                return "frozen"
            return "vis"
        if top == "text_encoder":
            return "frozen" if freeze_text else "text"
        if top == "ground_decoder" and "time_decoder" in keys:
            return "temp"
        if top.endswith("_clas"):
            return "clas"
        return "rest"

    return {n: label_one(n) for n in names}


def make_schedule(cfg, max_iter: int, group: str) -> Callable[[int], float]:
    """Learning rate of one group at a 0-based step (the number of completed
    updates), with the JAX package's +1 shift: the reference steps once at
    the base LR and adjusts afterwards with a 1-based counter."""
    s = cfg.SOLVER
    base = {"rest": s.BASE_LR, "vis": s.VIS_BACKBONE_LR, "text": s.TEXT_LR,
            "temp": s.TEMP_LR, "clas": s.VERB_LR}[group]
    warmup = max(1, round(s.WARMUP_PROP * max_iter))
    iter_per_epoch = max(1, round(max_iter / s.MAX_EPOCH))
    drop_steps = list(s.SCHEDULE.DROP_STEP)
    sched_type = s.SCHEDULE.TYPE
    if sched_type not in ("multistep_with_warmup_all", "multistep_with_warmup"):
        raise ValueError(f"Unsupported schedule type: {sched_type}")

    def schedule(step: int) -> float:
        step = float(step) + 1.0
        epoch = math.floor(step / iter_per_epoch)
        multistep = 0.1 ** sum(epoch >= d for d in drop_steps)
        warm = step / warmup
        lin_decay = max(0.0, (max_iter - step) / max(1, max_iter - warmup))
        if sched_type == "multistep_with_warmup_all":
            gamma = warm if step < warmup else multistep
        elif group in ("text", "temp"):
            gamma = warm if step < warmup else lin_decay
        else:
            gamma = multistep
        return base * gamma

    return schedule


class GroupedAdamW:
    """The grouped AdamW of the JAX package over a module's parameters,
    updated in place with ``torch._foreach`` ops (the f32 masters, their
    moments and the update stay on the device; no host sync)."""

    def __init__(self, cfg, model: nn.Module, max_iter: int):
        s = cfg.SOLVER
        if s.OPTIMIZER != "adamw":
            raise ValueError(f"only SOLVER.OPTIMIZER adamw is ported, not {s.OPTIMIZER}")
        named = dict(model.named_parameters())
        self.labels = label_params(named, cfg.MODEL.VIDEO_SWIN.FREEZE,
                                   cfg.MODEL.TEXT_MODEL.FREEZE)
        for name, p in named.items():
            p.requires_grad_(self.labels[name] != "frozen")
        self.groups: Dict[str, List[Tuple[str, nn.Parameter]]] = {
            g: [(n, p) for n, p in named.items() if self.labels[n] == g] for g in GROUPS[:-1]}
        self.schedules = {g: make_schedule(cfg, max_iter, g) for g in self.groups}
        self.weight_decay = s.WEIGHT_DECAY
        self.max_grad_norm = s.MAX_GRAD_NORM
        self.m = {n: torch.zeros_like(p) for g in self.groups.values() for n, p in g}
        self.v = {n: torch.zeros_like(p) for g in self.groups.values() for n, p in g}

    def trainable(self) -> List[Tuple[str, nn.Parameter]]:
        return [np_ for g in self.groups.values() for np_ in g]

    def clip_(self) -> torch.Tensor:
        """Scale the trainable gradients in place to a global norm of at most
        ``max_grad_norm``; returns the norm before clipping."""
        grads = [p.grad for _, p in self.trainable()]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        if self.max_grad_norm > 0:
            scale = self.max_grad_norm / torch.clamp(norm, min=self.max_grad_norm)
            torch._foreach_mul_(grads, scale)
        return norm

    @torch.no_grad()
    def step(self, step: int) -> torch.Tensor:
        """One update at 0-based ``step`` from the parameters' ``.grad``;
        returns the global gradient norm before clipping."""
        for _, p in self.trainable():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = self.clip_()
        t = step + 1
        bc1, bc2 = 1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t
        for group, members in self.groups.items():
            if not members:
                continue
            lr = self.schedules[group](step)
            params = [p for _, p in members]
            grads = [p.grad for p in params]
            m = [self.m[n] for n, _ in members]
            v = [self.v[n] for n, _ in members]
            torch._foreach_mul_(m, ADAM_B1)
            torch._foreach_add_(m, grads, alpha=1.0 - ADAM_B1)
            torch._foreach_mul_(v, ADAM_B2)
            torch._foreach_addcmul_(v, grads, grads, value=1.0 - ADAM_B2)
            denom = torch._foreach_div(v, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            update = torch._foreach_div(m, bc1)
            torch._foreach_div_(update, denom)
            torch._foreach_add_(update, params, alpha=self.weight_decay)
            torch._foreach_add_(params, update, alpha=-lr)
        return norm

    def state_dict(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"m": self.m, "v": self.v}

    def load_state_dict(self, state: Dict[str, Dict[str, torch.Tensor]]) -> None:
        for key in ("m", "v"):
            mine = getattr(self, key)
            if set(state[key]) != set(mine):
                raise KeyError(f"optimizer state {key} names other parameters")
            for n, t in state[key].items():
                mine[n].copy_(t)


@torch.no_grad()
def update_ema(params: Dict[str, torch.Tensor], ema: Dict[str, torch.Tensor],
               decay: float) -> None:
    """ema = ema * decay + params * (1 - decay), over every parameter (frozen
    ones included, as in the JAX package), in place."""
    names = list(ema)
    e = [ema[n] for n in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [params[n] for n in names], alpha=1.0 - decay)
