"""Frozen copy of the port module named below, imports made local; kernel calls go to
``plain_kernels``.

RoBERTa text encoder + grounding text tower (counterpart of
``vgqa_tpu/models/roberta.py``): post-LN transformer, learned positions
with a pad offset of 2, tanh pooler, and a ``FeatureResizer`` to d_model."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import dropout
from .layers import FeatureResizer, MultiHeadAttention


@dataclass(frozen=True)
class RobertaConfig:
    vocab_size: int = 50265
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    pad_token_id: int = 1
    layer_norm_eps: float = 1e-5
    dropout: float = 0.1

    @classmethod
    def tiny(cls) -> "RobertaConfig":
        return cls(vocab_size=128, hidden_size=32, num_layers=2, num_heads=4,
                   intermediate_size=64, max_position_embeddings=66)


class RobertaLayer(nn.Module):
    def __init__(self, c: RobertaConfig):
        super().__init__()
        self.dropout = c.dropout
        self.attention = MultiHeadAttention(c.hidden_size, c.num_heads, dropout=c.dropout)
        self.attention_ln = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.intermediate = nn.Linear(c.hidden_size, c.intermediate_size)
        self.output = nn.Linear(c.intermediate_size, c.hidden_size)
        self.output_ln = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)

    def forward(self, h, mask, rng=None):
        attn = self.attention(h, h, h, key_mask=mask, rng=rng)
        h = self.attention_ln(h + dropout(attn, self.dropout, rng))
        inter = F.gelu(self.intermediate(h), approximate="none")
        return self.output_ln(h + dropout(self.output(inter), self.dropout, rng))


class RobertaModel(nn.Module):
    def __init__(self, c: RobertaConfig):
        super().__init__()
        self.cfg = c
        self.dropout = c.dropout
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size)
        self.position_embeddings = nn.Embedding(c.max_position_embeddings, c.hidden_size)
        self.token_type_embeddings = nn.Embedding(c.type_vocab_size, c.hidden_size)
        self.embeddings_ln = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        for i in range(c.num_layers):
            setattr(self, f"layer_{i}", RobertaLayer(c))
        self.pooler = nn.Linear(c.hidden_size, c.hidden_size)

    def forward(self, token_ids, mask, rng=None):
        """token_ids [V, L] int, mask [V, L] bool -> (hidden [V, L, H], pooled [V, H])."""
        c = self.cfg
        # a tokenizer/model vocab mismatch is clamped (degrades, never NaN)
        token_ids = token_ids.clamp(0, c.vocab_size - 1)
        m = mask.long()
        position_ids = torch.cumsum(m, dim=-1) * m + c.pad_token_id
        h = self.embeddings_ln(
            self.word_embeddings(token_ids) + self.position_embeddings(position_ids)
            + self.token_type_embeddings(torch.zeros_like(token_ids)))
        h = dropout(h, self.dropout, rng)
        for i in range(c.num_layers):
            h = getattr(self, f"layer_{i}")(h, mask, rng)
        pooled = torch.tanh(self.pooler(h[:, 0]))
        return h, pooled


class TextEncoder(nn.Module):
    """RoBERTa + FeatureResizer: the grounding model's text tower. With
    ``freeze`` the resizer gets no gradient into RoBERTa."""

    def __init__(self, cfg: RobertaConfig, out_dim: int = 256, freeze: bool = False):
        super().__init__()
        self.freeze = freeze
        self.body = RobertaModel(cfg)
        self.resizer = FeatureResizer(cfg.hidden_size, out_dim, dropout=0.1)

    def forward(self, token_ids, mask, rng=None):
        hidden, pooled = self.body(token_ids, mask, rng)
        if self.freeze:
            hidden, pooled = hidden.detach(), pooled.detach()
        return self.resizer(hidden, rng), self.resizer(pooled, rng)
