"""Frozen copy of the port module named below, imports made local; kernel calls go to
``plain_kernels``.

BERT-style cross-attention blocks of the classifier heads (counterpart of
``vgqa_tpu/models/bert_blocks.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .dropout import dropout
from .layers import MultiHeadAttention


class BertCrossLayer(nn.Module):
    """Cross-attention + post-LN residual + GELU FFN; returns (out, probs)
    (probs before dropout)."""

    def __init__(self, d: int, num_heads: int = 8, eps: float = 1e-12,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.attention = MultiHeadAttention(d, num_heads, dropout=dropout)
        self.attention_ln = nn.LayerNorm(d, eps=eps)
        self.intermediate = nn.Linear(d, d)
        self.output = nn.Linear(d, d)
        self.output_ln = nn.LayerNorm(d, eps=eps)

    def forward(self, q, kv, kv_mask=None, rng=None):
        attn_out, probs = self.attention(q, kv, kv, key_mask=kv_mask, return_probs=True,
                                         rng=rng)
        attn_out = self.attention_ln(q + dropout(attn_out, self.dropout, rng))
        inter = F.gelu(self.intermediate(attn_out), approximate="none")
        out = dropout(self.output(inter), self.dropout, rng)
        return self.output_ln(out + attn_out), probs


class PredictionHead(nn.Module):
    """dense + GELU + LN transform, then a vocab projection with its own bias."""

    def __init__(self, d: int, vocab_size: int, eps: float = 1e-12):
        super().__init__()
        self.transform = nn.Linear(d, d)
        self.transform_ln = nn.LayerNorm(d, eps=eps)
        self.decoder = nn.Linear(d, vocab_size, bias=False)
        self.bias = nn.Parameter(torch.zeros(vocab_size))

    def forward(self, x):
        h = self.transform_ln(F.gelu(self.transform(x), approximate="none"))
        return self.decoder(h) + self.bias
