"""Dual query decoders: the temporal span decoder and the conditional-DETR
spatial box decoder with iterative anchor refinement (counterpart of
``vgqa_tpu/models/decoder.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.dropout import dropout
from ..ops.position_encoding import box_sine_embedding, sine_position_1d
from .layers import MLP, MultiHeadAttention, TransformerFFN


class TimeDecoderLayer(nn.Module):
    """Self-attention over frame queries + per-frame cross-attention into
    that frame's [text | swin] tokens."""

    def __init__(self, d: int, num_heads: int, ffn_dim: int, dropout: float = 0.1):
        super().__init__()
        self.dropout = dropout
        self.self_attn = MultiHeadAttention(d, num_heads, dropout=dropout)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.cross_attn = MultiHeadAttention(d, num_heads, dropout=dropout)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)
        self.ffn = TransformerFFN(d, ffn_dim, dropout)
        self.norm4 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, tgt, query_time, memory, memory_pos, memory_mask, time_mask,
                rng=None):
        q = tgt + query_time
        attn = self.self_attn(q, q, tgt, key_mask=time_mask, rng=rng)
        tgt = self.norm1(tgt + dropout(attn, self.dropout, rng))
        cross = self.cross_attn(tgt[:, :, None], memory + memory_pos, memory,
                                key_mask=memory_mask, rng=rng)[:, :, 0]
        tgt = self.norm3(tgt + dropout(cross, self.dropout, rng))
        return self.norm4(tgt + dropout(self.ffn(tgt, rng), self.dropout, rng))


class TimeDecoder(nn.Module):
    def __init__(self, num_layers: int, d: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            setattr(self, f"layer_{i}", TimeDecoderLayer(d, num_heads, ffn_dim, dropout))
        self.norm = nn.LayerNorm(d, eps=1e-5)

    def forward(self, tgt, query_time, memory, memory_pos, memory_mask, time_mask,
                rng=None):
        intermediate = []
        for i in range(self.num_layers):
            tgt = getattr(self, f"layer_{i}")(tgt, query_time, memory, memory_pos,
                                              memory_mask, time_mask, rng)
            intermediate.append(self.norm(tgt))
        return torch.stack(intermediate)                      # [n_layers, V, T, d]


class PosDecoderLayer(nn.Module):
    """Conditional-DETR decoder layer with concat-style cross attention."""

    def __init__(self, d: int, num_heads: int, ffn_dim: int, is_first: bool = False,
                 dropout: float = 0.1):
        super().__init__()
        self.num_heads = num_heads
        self.is_first = is_first
        self.dropout = dropout
        for name in ("sa_qcontent", "sa_qtime", "sa_qpos", "sa_kcontent",
                     "sa_ktime", "sa_kpos", "sa_v", "ca_qcontent", "ca_kcontent",
                     "ca_v", "ca_kpos", "ca_qpos_sine", "cross_out"):
            setattr(self, name, nn.Linear(d, d))
        if is_first:
            self.ca_qpos = nn.Linear(d, d)
        self.self_attn = MultiHeadAttention(d, num_heads, dropout=dropout)
        self.norm1 = nn.LayerNorm(d, eps=1e-5)
        self.norm3 = nn.LayerNorm(d, eps=1e-5)
        self.ffn = TransformerFFN(d, ffn_dim, dropout)
        self.norm4 = nn.LayerNorm(d, eps=1e-5)

    def forward(self, tgt, query_pos, query_time, query_sine, memory, memory_pos,
                memory_mask, time_mask, rng=None):
        d = tgt.shape[-1]
        H = self.num_heads
        q = self.sa_qcontent(tgt) + self.sa_qtime(query_time) + self.sa_qpos(query_pos)
        k = self.sa_kcontent(tgt) + self.sa_ktime(query_time) + self.sa_kpos(query_pos)
        v = self.sa_v(tgt)
        attn = self.self_attn(q, k, v, key_mask=time_mask, rng=rng)
        tgt = self.norm1(tgt + dropout(attn, self.dropout, rng))

        q_content = self.ca_qcontent(tgt)
        k_content = self.ca_kcontent(memory)
        v = self.ca_v(memory)
        k_pos = self.ca_kpos(memory_pos)
        sine = self.ca_qpos_sine(query_sine)
        if self.is_first:
            q_content = q_content + self.ca_qpos(query_pos)
            k_content = k_content + k_pos

        def headwise_concat(a, b):
            lead = a.shape[:-1]
            a = a.reshape(*lead, H, d // H)
            b = b.reshape(*lead, H, d // H)
            return torch.cat([a, b], dim=-1).reshape(*lead, 2 * d)

        q2 = headwise_concat(q_content, sine)[:, :, None]      # [V, T, 1, 2d]
        k2 = headwise_concat(k_content, k_pos)                 # [V, T, S, 2d]
        cross = dot_product_attention(
            q2, k2, v, H, key_mask=memory_mask[:, :, None],
            scale=float(2 * d // H) ** -0.5,
        )[:, :, 0]
        tgt = self.norm3(tgt + dropout(self.cross_out(cross), self.dropout, rng))
        return self.norm4(tgt + dropout(self.ffn(tgt, rng), self.dropout, rng))


class PosDecoder(nn.Module):
    """Iterative-anchor spatial decoder: per-layer boxes [n_layers, V, T, 4]
    in sigmoid space."""

    def __init__(self, num_layers: int, d: int, num_heads: int, ffn_dim: int,
                 sine_feats: int = 128, dropout: float = 0.1):
        super().__init__()
        self.num_layers = num_layers
        self.query_scale = MLP(d, d, d, 2)
        self.ref_point_head = MLP(4 * sine_feats, d, d, 2)
        self.bbox_embed = MLP(d, d, 4, 3)
        for i in range(num_layers):
            setattr(self, f"layer_{i}", PosDecoderLayer(d, num_heads, ffn_dim,
                                                        is_first=(i == 0), dropout=dropout))

    def forward(self, tgt, init_boxes, query_time, memory, memory_pos, memory_mask,
                time_mask, rng=None):
        d = tgt.shape[-1]
        pred_boxes = init_boxes
        anchors = []
        for i in range(self.num_layers):
            sine_full = box_sine_embedding(pred_boxes).to(tgt.dtype)   # [V, T, 4*128]
            query_pos = self.ref_point_head(sine_full)
            query_sine = sine_full[..., :d]
            if i > 0:
                query_sine = query_sine * self.query_scale(tgt)
            tgt = getattr(self, f"layer_{i}")(tgt, query_pos, query_time, query_sine,
                                              memory, memory_pos, memory_mask, time_mask,
                                              rng)
            new_boxes = torch.sigmoid(self.bbox_embed(tgt))
            anchors.append(new_boxes)
            pred_boxes = new_boxes.detach()      # the next layer's anchors: no gradient
        return torch.stack(anchors)


class QueryDecoder(nn.Module):
    """Dynamic query construction and both decoders."""

    def __init__(self, d: int, num_layers: int = 6, num_heads: int = 8,
                 ffn_dim: int = 2048, video_max_len: int = 200,
                 use_learned_time_embed: bool = False, dropout: float = 0.1):
        super().__init__()
        self.pos_fc_ln1 = nn.LayerNorm(d, eps=1e-12)
        self.pos_fc_linear = nn.Linear(d, 4)
        self.pos_fc_ln2 = nn.LayerNorm(4, eps=1e-12)
        # time_fc holds parameters the reference checkpoint carries; its
        # output is unused downstream (as in the JAX package)
        self.time_fc_ln1 = nn.LayerNorm(d, eps=1e-12)
        self.time_fc_linear = nn.Linear(d, d)
        self.time_fc_ln2 = nn.LayerNorm(d, eps=1e-12)
        if use_learned_time_embed:
            self.time_embed = nn.Parameter(torch.randn(video_max_len + 1, d))
        self.use_learned_time_embed = use_learned_time_embed
        self.time_decoder = TimeDecoder(num_layers, d, num_heads, ffn_dim, dropout)
        self.decoder = PosDecoder(num_layers, d, num_heads, ffn_dim, dropout=dropout)

    def forward(self, encoded: dict, init_spatial_query, init_temporal_query, time_mask,
                rng=None):
        h = encoded["encoded"]                                 # [V, T, S, d]
        V, T, S, d = h.shape
        hw, L = encoded["hw"], encoded["text_len"]
        vis_pos, vis_mask, text_mask = (encoded["vis_pos"], encoded["vis_mask"],
                                        encoded["text_mask"])

        # LN -> dropout (fixed 0.1, as in the JAX package) -> linear -> relu -> LN
        x = dropout(self.pos_fc_ln1(encoded["frames_cls"]), 0.1, rng)
        x = torch.relu(self.pos_fc_linear(x))
        init_boxes = torch.sigmoid(self.pos_fc_ln2(x))        # [V, T, 4]

        if self.use_learned_time_embed:
            query_time = self.time_embed[:T]
        else:
            query_time = sine_position_1d(T, d, device=h.device)
        query_time = query_time[None].expand(V, T, d).to(h.dtype)

        zeros_L = torch.zeros((V, T, L, d), dtype=h.dtype, device=h.device)
        pos_b = vis_pos[:, None].expand(V, T, hw, d)

        mem_t = h[:, :, hw:]                                   # [text | swin]
        pos_t = torch.cat([zeros_L, pos_b], dim=2)
        mask_t = torch.cat([text_mask, vis_mask], dim=1)[:, None].expand(V, T, L + hw)

        mem_s = h[:, :, :hw + L]                               # [resnet | text]
        pos_s = torch.cat([pos_b, zeros_L], dim=2)
        mask_s = torch.cat([vis_mask, text_mask], dim=1)[:, None].expand(V, T, hw + L)

        tgt_t = init_temporal_query[:, None].expand(V, T, d)
        outputs_time = self.time_decoder(tgt_t, query_time, mem_t, pos_t, mask_t, time_mask,
                                         rng)
        tgt_s = init_spatial_query[:, None].expand(V, T, d)
        outputs_pos = self.decoder(tgt_s, init_boxes, query_time, mem_s, pos_s, mask_s,
                                   time_mask, rng)
        return outputs_pos, outputs_time
