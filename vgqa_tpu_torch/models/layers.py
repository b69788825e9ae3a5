"""Shared building blocks (counterpart of ``vgqa_tpu/models/layers.py``).

Submodule names equal the flax names (``layers_0``, ``q_proj``, ``fc``, ...)
so that ``convert_jax.state_dict_from_jax`` maps a JAX parameter tree onto
these modules by one generic walk. Dropout is absent: this package serves
(inference) only so far.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.kernels.window_attention import window_attention


class MLP(nn.Module):
    """ReLU MLP head: ``layers_0 .. layers_{n-1}``, linear output."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            d_in = in_dim if i == 0 else hidden_dim
            d_out = output_dim if i == num_layers - 1 else hidden_dim
            setattr(self, f"layers_{i}", nn.Linear(d_in, d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x


class FeatureResizer(nn.Module):
    """Linear projection + LayerNorm(eps=1e-12)."""

    def __init__(self, in_dim: int, output_dim: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, output_dim)
        self.layer_norm = nn.LayerNorm(output_dim, eps=1e-12)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layer_norm(self.fc(x))


class LearnedPosition2D(nn.Module):
    """Learnable 2D positions from 50-entry row/col tables; channel order is
    x-embed then y-embed."""

    def __init__(self, num_pos_feats: int = 128, table_size: int = 50):
        super().__init__()
        self.row_embed = nn.Parameter(torch.empty(table_size, num_pos_feats))
        self.col_embed = nn.Parameter(torch.empty(table_size, num_pos_feats))
        nn.init.uniform_(self.row_embed)
        nn.init.uniform_(self.col_embed)

    def forward(self, h: int, w: int) -> torch.Tensor:
        """Returns [h, w, 2*num_pos_feats]."""
        n = self.row_embed.shape[1]
        x_emb = self.col_embed[None, :w].expand(h, w, n)
        y_emb = self.row_embed[:h, None].expand(h, w, n)
        return torch.cat([x_emb, y_emb], dim=-1)


class MultiHeadAttention(nn.Module):
    """Projected multi-head attention (q/k/v/out projections).

    With ``use_flash`` set and no probabilities requested, the attention core
    is the ``window_attention`` kernel (one row per leading index, heads
    packed in the channel dim, key padding as a column mask) — the
    counterpart of the JAX kernel route; otherwise the einsum core."""

    def __init__(self, d_model: int, num_heads: int, kv_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, use_flash: bool = False):
        super().__init__()
        kv_dim = kv_dim or d_model
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(kv_dim, d_model)
        self.v_proj = nn.Linear(kv_dim, d_model)
        self.out_proj = nn.Linear(d_model, out_dim or d_model)

    def forward(self, query, key, value, key_mask=None, return_probs=False):
        q = self.q_proj(query)
        k = self.k_proj(key)
        v = self.v_proj(value)
        if self.use_flash and not return_probs:
            lead = q.shape[:-2]
            n, d = q.shape[-2:]
            kv = None
            if key_mask is not None:
                kv = key_mask.expand(*lead, key_mask.shape[-1]).reshape(-1, key_mask.shape[-1])
            out = window_attention(
                q.reshape(-1, n, d), k.reshape(-1, n, d), v.reshape(-1, n, d),
                key_valid=kv, num_heads=self.num_heads,
            ).reshape(*lead, n, d)
            return self.out_proj(out)
        out = dot_product_attention(q, k, v, self.num_heads, key_mask=key_mask,
                                    return_probs=return_probs)
        if return_probs:
            out, probs = out
            return self.out_proj(out), probs
        return self.out_proj(out)


class TransformerFFN(nn.Module):
    """linear1 -> ReLU -> linear2 (residual and norm by the caller)."""

    def __init__(self, d_model: int, ffn_dim: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear2(torch.relu(self.linear1(x)))
