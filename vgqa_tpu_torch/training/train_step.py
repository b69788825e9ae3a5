"""The training step and its state (counterpart of
``vgqa_tpu/training/train_step.py``).

One step: the uint8 frames are normalized on the device, the model runs its
training forward, the weighted loss terms are summed, autograd gives the
gradients of the trainable parameters, the grouped AdamW (with the global
clip) updates them in place, and the EMA follows.

Mixed precision is the JAX package's, not ``torch.autocast``: with
``compute_dtype=torch.bfloat16`` the master parameters, the optimizer state
and the EMA stay float32, the forward runs on bf16 copies made by a
differentiable cast (``torch.func.functional_call``), so the gradients land
on the f32 masters, and the outputs are upcast to f32 for the loss. The
bf16 copies of frozen parameters are made once and kept.

Dropout draws from a ``DropoutRng`` seeded from (seed, step), as the JAX step
folds the step into its key: a resumed run repeats an uninterrupted one.

Data parallelism (a ``torch.distributed`` group, ``parallel/``): each rank
runs the step on its slice of the global batch with its rank folded into
the dropout seeds; the loss divides by the group's counts
(``models/loss.py``), and after the backward every trainable gradient is
replaced by its mean over the group (``parallel.distributed.
average_gradients``), so the clip sees the global norm and every rank
applies the same update: the ranks' parameters, moments and EMA stay
bit-equal.

Traced (``utils/trace``): ``vgqa.train.step`` per step, with the children
``vgqa.train.forward``, ``.loss``, ``.backward``, ``.allreduce`` (in a
process group only), ``.optimizer`` (clip and AdamW) and ``.ema``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import torch
from torch import nn

from ..ops.dropout import DropoutRng
from ..ops.kernels.dtypes import check_kernel_dtype
from ..parallel import distributed
from ..utils import trace
from ..utils.containers import TextBatch, VideoBatch, normalize_uint8_video
from .optimizer import GroupedAdamW, update_ema


@dataclass
class TrainState:
    step: int
    model: nn.Module                       # f32 master parameters
    optimizer: GroupedAdamW
    ema: Optional[Dict[str, torch.Tensor]]  # None when EMA is off
    cast_cache: Dict[str, torch.Tensor] = field(default_factory=dict)


def create_train_state(model: nn.Module, optimizer: GroupedAdamW, use_ema: bool) -> TrainState:
    ema = None
    if use_ema:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(0, model, optimizer, ema)


def step_seed(seed: int, step: int) -> int:
    """The dropout seed of one step (the JAX step's ``fold_in(rng, step)``)."""
    return (int(seed) * 1_000_003 + int(step)) % (1 << 62)


def _upcast(tree):
    if isinstance(tree, torch.Tensor):
        return tree.float() if tree.dtype == torch.bfloat16 else tree
    if isinstance(tree, dict):
        return {k: _upcast(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_upcast(v) for v in tree)
    return tree


def make_train_step(loss_fn, weight_dict: Dict[str, float],
                    ema_decay: Optional[float] = 0.9998,
                    compute_dtype: Optional[torch.dtype] = None,
                    pixel_stats: Optional[Any] = None):
    """Returns ``step_fn(state, video, text, targets, seed) -> metrics``,
    which updates ``state`` in place. ``step_fn.loss_and_grads`` runs the
    forward and backward only (gradients left in ``.grad``, averaged over a
    data-parallel group) and returns this rank's ``(total, losses)``.
    ``pixel_stats=(mean, std)`` normalizes a uint8 feed on the device."""

    def params_for_forward(state: TrainState) -> Dict[str, torch.Tensor]:
        if compute_dtype is None:
            return dict(state.model.named_parameters())
        out = {}
        for n, p in state.model.named_parameters():
            if p.dtype != torch.float32:
                out[n] = p
            elif p.requires_grad:
                out[n] = p.to(compute_dtype)          # differentiable cast
            else:
                if n not in state.cast_cache:
                    state.cast_cache[n] = p.detach().to(compute_dtype)
                out[n] = state.cast_cache[n]
        return out

    def check_dtype(state: TrainState, video: VideoBatch) -> None:
        cfg = getattr(state.model, "cfg", None)
        if video.frames.device.type == "cuda" and getattr(cfg, "use_pallas_attention", False):
            check_kernel_dtype("the CUDA kernels of the training path",
                               compute_dtype or torch.float32)

    def loss_and_grads(state: TrainState, video: VideoBatch, text: TextBatch,
                       targets: Dict, seed: int):
        check_dtype(state, video)
        if video.frames.dtype == torch.uint8:
            video = normalize_uint8_video(video, pixel_stats,
                                          dtype=compute_dtype or torch.float32)
        elif compute_dtype is not None:
            video = VideoBatch(video.frames.to(compute_dtype), video.pixel_mask,
                               video.time_mask)
        rng = DropoutRng(step_seed(seed, state.step), video.frames.device,
                         rank=distributed.get_rank())
        for p in state.model.parameters():
            p.grad = None
        with trace.span("vgqa.train.forward"):
            out = torch.func.functional_call(state.model, params_for_forward(state),
                                             (video, text), {"train": True, "rng": rng})
        with trace.span("vgqa.train.loss"):
            losses = loss_fn(_upcast(out), targets)
            total = sum(losses[k] * weight_dict[k] for k in losses if k in weight_dict)
        with trace.span("vgqa.train.backward"):
            total.backward()
        distributed.average_gradients(p for p in state.model.parameters() if p.requires_grad)
        return total.detach(), {k: v.detach() for k, v in losses.items()}

    def step_fn(state: TrainState, video: VideoBatch, text: TextBatch, targets: Dict,
                seed: int) -> Dict[str, torch.Tensor]:
        with trace.span("vgqa.train.step"):
            total, losses = loss_and_grads(state, video, text, targets, seed)
            with trace.span("vgqa.train.optimizer"):
                grad_norm = state.optimizer.step(state.step)
            if state.ema is not None and ema_decay is not None:
                with trace.span("vgqa.train.ema"):
                    update_ema(dict(state.model.named_parameters()), state.ema, ema_decay)
            state.step += 1
        return {"loss": total, "grad_norm": grad_norm, **losses}

    step_fn.loss_and_grads = loss_and_grads
    return step_fn
