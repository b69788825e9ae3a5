"""Head-dim padding of the attention wrappers.

Each attention kernel is compiled for one head dim: 32 for K1's attention,
K2 and K3, 64 for K4, 128 for K5. The Pallas kernels they replace pad the
head dim up to their block (128) and take any smaller one, so the wrappers
do the same: q, k and v are zero-padded per head up to the kernel's head
dim, the kernel runs with the softmax scale of the true head dim, and the
output is sliced back. Zero channels add nothing to q k^T, and the padded
value channels give zero output channels, which are dropped.

A head dim above the kernel's, or a dtype the kernel does not take, cannot
be padded: the wrapper raises for it on the card, as for any other shape
its kernel does not take.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_heads(x: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """``[..., H*dh]`` -> ``[..., H*head_dim]``: each head's channels
    followed by ``head_dim - dh`` zeros (``x`` itself when dh == head_dim).
    Differentiable."""
    *lead, C = x.shape
    dh = C // heads
    if dh == head_dim:
        return x
    if dh > head_dim or C % heads:
        raise ValueError(f"{C} channels in {heads} heads do not pad to head dim {head_dim}")
    return F.pad(x.reshape(*lead, heads, dh), (0, head_dim - dh)).reshape(
        *lead, heads * head_dim)


def unpad_heads(x: torch.Tensor, heads: int, dh: int) -> torch.Tensor:
    """Inverse of :func:`pad_heads`: ``[..., H*head_dim]`` -> ``[..., H*dh]``."""
    *lead, C = x.shape
    if C == heads * dh:
        return x
    return x.reshape(*lead, heads, C // heads)[..., :dh].reshape(*lead, heads * dh)


def pad_last(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """``[..., dh]`` -> ``[..., head_dim]`` with zeros (one head per row)."""
    dh = x.shape[-1]
    return x if dh == head_dim else F.pad(x, (0, head_dim - dh))
