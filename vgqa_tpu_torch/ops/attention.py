"""Masked multi-head attention core (counterpart of ``vgqa_tpu/ops/attention.py``).

q/k/v arrive pre-projected with the heads packed in the channel dimension.
Logits and the softmax run in float32; the probabilities are cast to the
input dtype before the value product, as in the JAX core. Masks are
True = attend; masked logits get ``NEG_INF``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

NEG_INF = -1e30


def split_heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[..., L, H*D] -> [..., H, L, D]"""
    *lead, L, dim = x.shape
    return x.reshape(*lead, L, num_heads, dim // num_heads).movedim(-2, -3)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., H, L, D] -> [..., L, H*D]"""
    x = x.movedim(-3, -2)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    attn_bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    dropout_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    return_probs: bool = False,
):
    """Scaled dot-product attention over pre-projected q/k/v.

    q: [..., Lq, Dqk], k: [..., Lk, Dqk], v: [..., Lk, Dv]
    key_mask: [..., Lk] bool (True = valid) or [..., Lq, Lk]
    attn_bias: broadcastable to [..., H, Lq, Lk]
    dropout_fn: applied to the probabilities before the value product (train)

    Returns out [..., Lq, Dv], and probs [..., H, Lq, Lk] (before dropout)
    if requested."""
    qh = split_heads(q, num_heads)
    kh = split_heads(k, num_heads)
    vh = split_heads(v, num_heads)
    if scale is None:
        scale = qh.shape[-1] ** -0.5
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    if attn_bias is not None:
        logits = logits + attn_bias
    if key_mask is not None:
        if key_mask.dim() == logits.dim() - 2:  # [..., Lk]
            m = key_mask[..., None, None, :]
        else:  # [..., Lq, Lk]
            m = key_mask[..., None, :, :]
        logits = logits.masked_fill(~m, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    weights = dropout_fn(probs) if dropout_fn is not None else probs
    out = torch.matmul(weights.float(), vh.float()).to(q.dtype)
    out = merge_heads(out)
    if return_probs:
        return out, probs
    return out
