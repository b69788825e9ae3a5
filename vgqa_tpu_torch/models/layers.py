"""Shared building blocks (counterpart of ``vgqa_tpu/models/layers.py``).

Submodule names equal the flax names (``layers_0``, ``q_proj``, ``fc``, ...)
so that ``convert_jax.state_dict_from_jax`` maps a JAX parameter tree onto
these modules by one generic walk. Every ``forward`` takes ``rng``: a
``DropoutRng`` in training (dropout active), None in eval.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.dropout import dropout
from ..ops.kernels.flash_train import flash_mha_train, supported_seq
from ..ops.kernels.window_attention import window_attention


class MLP(nn.Module):
    """ReLU MLP head: ``layers_0 .. layers_{n-1}``, linear output, optional
    dropout between layers."""

    def __init__(self, in_dim: int, hidden_dim: int, output_dim: int,
                 num_layers: int, dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        for i in range(num_layers):
            d_in = in_dim if i == 0 else hidden_dim
            d_out = output_dim if i == num_layers - 1 else hidden_dim
            setattr(self, f"layers_{i}", nn.Linear(d_in, d_out))

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = dropout(torch.relu(x), self.dropout, rng)
        return x


class FeatureResizer(nn.Module):
    """Linear projection + LayerNorm(eps=1e-12) + dropout."""

    def __init__(self, in_dim: int, output_dim: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.fc = nn.Linear(in_dim, output_dim)
        self.layer_norm = nn.LayerNorm(output_dim, eps=1e-12)

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        return dropout(self.layer_norm(self.fc(x)), self.dropout, rng)


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
    """Projected multi-head attention (q/k/v/out projections) with dropout on
    the probabilities in training.

    With ``use_flash`` set and no probabilities requested, the attention core
    is a kernel route, as in the JAX package: in eval the ``window_attention``
    kernel (one row per leading index, heads packed in the channel dim, key
    padding as a column mask); in training the differentiable
    ``flash_mha_train`` kernel with in-kernel dropout when ``supported_seq``
    holds, its seed drawn per call from the step's host generator. Otherwise
    the einsum core."""

    def __init__(self, d_model: int, num_heads: int, kv_dim: Optional[int] = None,
                 out_dim: Optional[int] = None, use_flash: bool = False,
                 dropout: float = 0.0):
        super().__init__()
        kv_dim = kv_dim or d_model
        self.num_heads = num_heads
        self.use_flash = use_flash
        self.dropout = dropout
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(kv_dim, d_model)
        self.v_proj = nn.Linear(kv_dim, d_model)
        self.out_proj = nn.Linear(d_model, out_dim or d_model)

    def forward(self, query, key, value, key_mask=None, return_probs=False, rng=None):
        q = self.q_proj(query)
        k = self.k_proj(key)
        v = self.v_proj(value)
        if self.use_flash and not return_probs and rng is not None:
            if supported_seq(q.shape[-2], k.shape[-2]):
                seed = rng.seed() if self.dropout > 0 else 0
                return self.out_proj(flash_mha_train(
                    q, k, v, self.num_heads, key_mask=key_mask,
                    dropout_rate=self.dropout, seed=seed))
        elif self.use_flash and not return_probs:
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
        drop = None
        if self.dropout > 0 and rng is not None:
            drop = lambda p: rng.dropout(p, self.dropout)  # noqa: E731
        out = dot_product_attention(q, k, v, self.num_heads, key_mask=key_mask,
                                    dropout_fn=drop, return_probs=return_probs)
        if return_probs:
            out, probs = out
            return self.out_proj(out), probs
        return self.out_proj(out)


class TransformerFFN(nn.Module):
    """linear1 -> ReLU -> dropout -> linear2 (residual and norm by the caller)."""

    def __init__(self, d_model: int, ffn_dim: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.linear1 = nn.Linear(d_model, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, d_model)

    def forward(self, x: torch.Tensor, rng=None) -> torch.Tensor:
        return self.linear2(dropout(torch.relu(self.linear1(x)), self.dropout, rng))
