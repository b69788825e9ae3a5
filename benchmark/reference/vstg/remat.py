"""Frozen copy of the port module named below, imports made local; kernel calls go to
``plain_kernels``.

Per-layer gradient checkpointing (``TPU.REMAT``; the JAX package's
``nn.remat``)."""

from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


def remat_call(layer: nn.Module, *args, rng=None):
    """``layer(*args)`` (with ``rng=rng`` when given) under
    ``torch.utils.checkpoint``: the backward recomputes the layer from its
    inputs. The recomputation reuses the parameter tensors of the forward
    (the bf16 copies of a mixed-precision step exist only inside that
    forward's ``functional_call``) and rewinds the step's generators, so it
    draws the forward's dropout masks and kernel seeds again."""
    params = dict(layer.named_parameters())
    kwargs = {} if rng is None else {"rng": rng}
    saved = None if rng is None else rng.get_state()
    calls = []

    def run(*a):
        if not calls:                              # the forward
            calls.append(1)
            return layer(*a, **kwargs)
        now = None if rng is None else rng.get_state()
        if rng is not None:
            rng.set_state(saved)
        try:
            return torch.func.functional_call(layer, params, a, kwargs)
        finally:
            if rng is not None:
                rng.set_state(now)

    return checkpoint(run, *args, use_reentrant=False, preserve_rng_state=False)
