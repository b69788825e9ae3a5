"""Frozen copy of the port module named below, imports made local; kernel calls go to
``plain_kernels``.

Cross-modal encoder and the text-guided classifier heads (counterpart of
``vgqa_tpu/models/encoder.py``). Layout is a static ``[V, T, S, d]`` with
S = hw + L + hw (ResNet | text | Swin tokens of each frame)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from .dropout import dropout
from .bert_blocks import BertCrossLayer, PredictionHead
from .layers import MultiHeadAttention, TransformerFFN
from .remat import remat_call


class EncoderLayer(nn.Module):
    """Post-LN encoder layer; q/k carry additive positions. Its per-frame
    self-attention is a kernel route when ``use_flash`` is set
    (``window_attention`` in eval, ``flash_mha_train`` in training)."""

    def __init__(self, d: int, num_heads: int, ffn_dim: int, use_flash: bool = False,
                 dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d, num_heads, use_flash=use_flash,
                                            dropout=dropout)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.ffn = TransformerFFN(d, ffn_dim, dropout)
        self.norm2 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, src, pos, mask, rng=None):
        q = src + pos
        attn = self.self_attn(q, q, src, key_mask=mask, rng=rng)
        src = self.norm1(src + dropout(attn, self.dropout, rng))
        ffn = self.ffn(src, rng)
        return self.norm2(src + dropout(ffn, self.dropout, rng))


class CrossModalEncoder(nn.Module):
    def __init__(self, d: int, num_layers: int = 6, num_heads: int = 8,
                 ffn_dim: int = 2048, use_flash: bool = False, dropout: float = 0.1,
                 remat: bool = False):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        for i in range(num_layers):
            setattr(self, f"layer_{i}", EncoderLayer(d, num_heads, ffn_dim, use_flash,
                                                     dropout))
        self.norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, vis_tokens, swin_tokens, text_tokens, vis_pos, vis_mask,
                text_mask, time_mask, rng=None):
        """vis/swin_tokens [V, T, hw, d], text_tokens [V, L, d], vis_pos
        [V, hw, d], vis_mask [V, hw], text_mask [V, L], time_mask [V, T]."""
        V, T, hw, d = vis_tokens.shape
        L = text_tokens.shape[1]
        text_b = text_tokens[:, None].expand(V, T, L, d)
        src = torch.cat([vis_tokens, text_b, swin_tokens], dim=2)
        zeros_L = torch.zeros((V, L, d), dtype=src.dtype, device=src.device)
        pos = torch.cat([vis_pos, zeros_L, vis_pos], dim=1)[:, None].expand_as(src)

        # one valid key per frame, always
        vis_mask = vis_mask.clone()
        vis_mask[:, 0] = True
        mask = torch.cat([vis_mask, text_mask, vis_mask], dim=1)
        mask = mask[:, None].expand(V, T, hw + L + hw)

        h = src
        for i in range(self.num_layers):
            layer = getattr(self, f"layer_{i}")
            if self.remat and torch.is_grad_enabled():
                h = remat_call(layer, h, pos, mask, rng=rng)     # per-layer checkpointing
            else:
                h = layer(h, pos, mask, rng=rng)
        h = self.norm(h)

        frames_cls = h.mean(dim=2)
        tm = time_mask.to(h.dtype)[..., None]
        videos_cls = (frames_cls * tm).sum(1) / tm.sum(1).clamp(min=1.0)
        return {
            "encoded": h, "frames_cls": frames_cls, "videos_cls": videos_cls,
            "vis_pos": vis_pos, "vis_mask": vis_mask, "text_mask": text_mask,
            "hw": hw, "text_len": L,
        }


class TemporalSampling(nn.Module):
    """Per-frame relevance: pooled frame features cross-attend the text
    through BERT cross layers; a vocab-1 head gives one logit per frame."""

    def __init__(self, d: int, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer_ca_{i}", BertCrossLayer(d))
        self.head = PredictionHead(d, 1)

    def forward(self, frame_feats, text_ctx, text_mask: Optional[torch.Tensor] = None,
                rng=None):
        x = frame_feats.mean(dim=2)
        for i in range(self.num_layers):
            x, _ = getattr(self, f"layer_ca_{i}")(x, text_ctx, kv_mask=text_mask, rng=rng)
        return self.head(x)[..., 0]


class SpatialActivation(nn.Module):
    """Attribute/verb classifier + per-frame spatial attention map; runs on
    every frame, and the caller reduces with a frame mask."""

    def __init__(self, d: int, vocab_size: int, num_layers: int = 2):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer_ca_{i}", BertCrossLayer(d))
        self.head = PredictionHead(d, vocab_size)

    def forward(self, frame_tokens, init_q, frame_mask, rng=None):
        """frame_tokens [V, T, hw, d], init_q [V, 1, d], frame_mask [V, T]."""
        V, T, hw, d = frame_tokens.shape
        query = init_q[:, None].expand(V, T, 1, d)
        probs = None
        for i in range(self.num_layers):
            query, probs = getattr(self, f"layer_ca_{i}")(query, frame_tokens, rng=rng)
        att = torch.sigmoid(probs.sum(dim=2)[..., 0, :])          # [V, T, hw]
        att_min = att.amin(dim=-1, keepdim=True)
        att_max = att.amax(dim=-1, keepdim=True)
        att = (att - att_min) / (att_max - att_min + 1e-6)
        logits_all = self.head(query[..., 0, :])
        fm = frame_mask.to(logits_all.dtype)[..., None]
        logits = (logits_all * fm).sum(1) / fm.sum(1).clamp(min=1.0)
        return logits, att
