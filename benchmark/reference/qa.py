"""Plain float32 reference of InternVideo2.5-Chat-8B's QA path: InternViT
(patch 14, class token, 24 pre-norm blocks with layer scales, erf GELU),
the 0.5 pixel shuffle and the MLP projector, the "internvl2_5" chat prompt
with one IMG_CONTEXT span per frame, and the InternLM2.5 decoder (RMSNorm,
split-half rotary positions with theta 1e6, grouped-query causal attention,
SiLU-gated MLP, untied head), run over a whole sequence in float32 keys and
values (the prompt's prefix, which every question about the same frames
shares, once per video): no quantized cache, no kernels, no batching.

The modules carry the parameter names the served modules use, so one
weight dictionary serves both. Weights may be stored in bfloat16; every
layer computes in float32 from an upcast copy, one layer at a time. Every
product is a ``torch.matmul``, so that ``precision.Float8Products`` (the
control) reaches all of them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .precision import Float8Products

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
SYSTEM_PROMPT = (
    "你是书生·万象，英文名"
    "是InternVL，是由上海人工智能"
    "实验室、清华大学及多家"
    "合作单位联合开发的多模"
    "态大语言模型。"
)


@dataclass(frozen=True)
class VitGeometry:
    image_size: int = 448
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    llm_hidden_size: int = 4096
    downsample_ratio: float = 0.5
    layer_norm_eps: float = 1e-6


@dataclass(frozen=True)
class LlmGeometry:
    vocab_size: int = 92553
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14336
    rope_theta: float = 1000000.0
    rms_eps: float = 1e-5


class RMSNorm(nn.Module):
    """RMSNorm's parameter holder (``weight``); see ``_rms``."""

    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))


class ViTBlock(nn.Module):
    def __init__(self, g: VitGeometry):
        super().__init__()
        d = g.hidden_size
        self.norm1 = nn.LayerNorm(d, eps=g.layer_norm_eps)
        self.qkv = nn.Linear(d, 3 * d)
        self.proj = nn.Linear(d, d)
        self.ls1 = nn.Parameter(torch.ones(d))
        self.norm2 = nn.LayerNorm(d, eps=g.layer_norm_eps)
        self.fc1 = nn.Linear(d, g.intermediate_size)
        self.fc2 = nn.Linear(g.intermediate_size, d)
        self.ls2 = nn.Parameter(torch.ones(d))


class VisionTower(nn.Module):
    def __init__(self, g: VitGeometry):
        super().__init__()
        self.g = g
        n = g.image_size // g.patch_size
        self.patch_embed = nn.Conv2d(3, g.hidden_size, g.patch_size, stride=g.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, g.hidden_size))
        self.pos_embed = nn.Parameter(torch.zeros(1, n * n + 1, g.hidden_size))
        for i in range(g.num_layers):
            self.add_module(f"block_{i}", ViTBlock(g))
        mixed = int(g.hidden_size / g.downsample_ratio ** 2)
        self.proj_norm = nn.LayerNorm(mixed, eps=1e-5)
        self.proj_fc1 = nn.Linear(mixed, g.llm_hidden_size)
        self.proj_fc2 = nn.Linear(g.llm_hidden_size, g.llm_hidden_size)


class DecoderLayer(nn.Module):
    def __init__(self, g: LlmGeometry):
        super().__init__()
        hd = g.hidden_size // g.num_heads
        self.attn_norm = RMSNorm(g.hidden_size)
        self.q_proj = nn.Linear(g.hidden_size, g.num_heads * hd, bias=False)
        self.k_proj = nn.Linear(g.hidden_size, g.num_kv_heads * hd, bias=False)
        self.v_proj = nn.Linear(g.hidden_size, g.num_kv_heads * hd, bias=False)
        self.o_proj = nn.Linear(g.num_heads * hd, g.hidden_size, bias=False)
        self.mlp_norm = RMSNorm(g.hidden_size)
        self.gate_proj = nn.Linear(g.hidden_size, g.intermediate_size, bias=False)
        self.up_proj = nn.Linear(g.hidden_size, g.intermediate_size, bias=False)
        self.down_proj = nn.Linear(g.intermediate_size, g.hidden_size, bias=False)


class LLM(nn.Module):
    def __init__(self, g: LlmGeometry):
        super().__init__()
        self.g = g
        for i in range(g.num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(g))
        self.final_norm = RMSNorm(g.hidden_size)
        self.lm_head = nn.Linear(g.hidden_size, g.vocab_size, bias=False)


class TokenEmbedding(nn.Module):
    def __init__(self, g: LlmGeometry):
        super().__init__()
        self.tok_embeddings = nn.Embedding(g.vocab_size, g.hidden_size)


class QAModel(nn.Module):
    """The three parts under the names ``llm``, ``embed`` and ``vision``."""

    def __init__(self, llm: LlmGeometry, vit: VitGeometry):
        super().__init__()
        self.llm = LLM(llm)
        self.embed = TokenEmbedding(llm)
        self.vision = VisionTower(vit)


def _linear(x, w, b=None):
    y = torch.matmul(x, w.float().t())
    return y if b is None else y + b.float()


def _ln(x, mod, eps):
    return F.layer_norm(x, x.shape[-1:], mod.weight.float(), mod.bias.float(), eps)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


# -- vision ----------------------------------------------------------------------
@torch.no_grad()
def vision_tokens(tower: VisionTower, tiles: torch.Tensor) -> torch.Tensor:
    """uint8 tiles [n, S, S, 3] -> [n, tokens, llm_hidden] f32."""
    g = tower.g
    dev = tiles.device
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    x = ((tiles.float() / 255.0 - mean) / std).permute(0, 3, 1, 2)
    n = tiles.shape[0]
    grid = g.image_size // g.patch_size
    w = tower.patch_embed.weight.float()
    # the patch convolution as a product over flattened patches
    patches = x.reshape(n, 3, grid, g.patch_size, grid, g.patch_size)
    patches = patches.permute(0, 2, 4, 1, 3, 5).reshape(n, grid * grid, -1)
    h = _linear(patches, w.reshape(w.shape[0], -1), tower.patch_embed.bias)
    h = torch.cat([tower.cls_token.float().expand(n, 1, -1), h], 1) + tower.pos_embed.float()
    H = g.num_heads
    D = g.hidden_size // H
    for i in range(g.num_layers):
        b = getattr(tower, f"block_{i}")
        y = _ln(h, b.norm1, g.layer_norm_eps)
        q, k, v = _linear(y, b.qkv.weight, b.qkv.bias).chunk(3, -1)
        q, k, v = (t.reshape(n, -1, H, D).transpose(1, 2) for t in (q, k, v))
        p = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) * D ** -0.5, -1)
        a = torch.matmul(p, v).transpose(1, 2).reshape(n, -1, g.hidden_size)
        h = h + _linear(a, b.proj.weight, b.proj.bias) * b.ls1.float()
        y = F.gelu(_linear(_ln(h, b.norm2, g.layer_norm_eps), b.fc1.weight, b.fc1.bias))
        h = h + _linear(y, b.fc2.weight, b.fc2.bias) * b.ls2.float()
    r = int(1 / g.downsample_ratio)
    patch = h[:, 1:].reshape(n, grid // r, r, grid // r, r, g.hidden_size)
    patch = patch.permute(0, 1, 3, 2, 4, 5).reshape(n, (grid // r) ** 2, -1)
    y = F.gelu(_linear(_ln(patch, tower.proj_norm, 1e-5), tower.proj_fc1.weight,
                       tower.proj_fc1.bias))
    return _linear(y, tower.proj_fc2.weight, tower.proj_fc2.bias)


# -- prompt ----------------------------------------------------------------------
def prompt_prefix(tok, frames: int, image_tokens: int):
    """The "internvl2_5" template up to the question, the part that every
    question about the same frames shares: (ids, image-token positions)."""
    enc = tok.encode
    ids: List[int] = [tok.BOS]
    ids += [tok.IM_START] + enc("system\n" + SYSTEM_PROMPT)
    ids += [tok.IM_END] + enc("\n")
    ids += [tok.IM_START] + enc("user\n")
    pos: List[int] = []
    for i in range(frames):
        ids += enc(f"Frame{i + 1}: ") + [tok.IMG_START]
        for _ in range(image_tokens):
            pos.append(len(ids))
            ids.append(tok.IMG_CONTEXT)
        ids += [tok.IMG_END] + enc("\n")
    return ids, pos


def prompt_tail(tok, question: str) -> List[int]:
    """The template from the question on."""
    enc = tok.encode
    return enc(question) + [tok.IM_END] + enc("\n") + [tok.IM_START] + enc("assistant\n")


def prompt_ids(tok, question: str, frames: int, image_tokens: int):
    """The whole "internvl2_5" prompt: (ids, image-token positions)."""
    ids, pos = prompt_prefix(tok, frames, image_tokens)
    return ids + prompt_tail(tok, question), pos


# -- the decoder -----------------------------------------------------------------
def _embed(model: QAModel, ids: List[int], img_pos: List[int], img_tokens, dev):
    g = model.llm.g
    ids_t = torch.tensor(ids, device=dev).clamp(0, g.vocab_size - 1)
    x = model.embed.tok_embeddings.weight[ids_t].float()
    if img_pos:
        x[torch.tensor(img_pos, device=dev)] = img_tokens.reshape(
            -1, img_tokens.shape[-1]).float()
    return x


@torch.no_grad()
def _layers(model: QAModel, x: torch.Tensor, start: int, past, q_chunk: int = 1024):
    """The decoder's layers over the positions [start, start + n) that the
    embeddings ``x`` [n, hidden] hold, attending causally to the keys and
    values ``past`` of the positions before them (per layer [kv_heads,
    start, head_dim] each; None when ``start`` is 0). Returns (the hidden
    states after the last layer, the keys and values of [0, start + n))."""
    g = model.llm.g
    dev = x.device
    n = x.shape[0]
    H, KV = g.num_heads, g.num_kv_heads
    hd = g.hidden_size // H
    inv = 1.0 / (g.rope_theta ** (torch.arange(0, hd, 2, device=dev).float() / hd))
    ang = torch.arange(start, start + n, device=dev).float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]

    def rope(t):
        a, b = t.chunk(2, -1)
        return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)

    kv_out = []
    for i in range(g.num_layers):
        p = getattr(model.llm, f"layer_{i}")
        h = _rms(x, p.attn_norm.weight, g.rms_eps)
        q = rope(_linear(h, p.q_proj.weight).reshape(n, H, hd)).transpose(0, 1)
        k = rope(_linear(h, p.k_proj.weight).reshape(n, KV, hd)).transpose(0, 1)
        v = _linear(h, p.v_proj.weight).reshape(n, KV, hd).transpose(0, 1)
        if past is not None:
            k = torch.cat([past[i][0], k], 1)
            v = torch.cat([past[i][1], v], 1)
        kv_out.append((k, v))
        kr = k.repeat_interleave(H // KV, 0)                           # [H, start + n, hd]
        vr = v.repeat_interleave(H // KV, 0)
        ctx = torch.empty(H, n, hd, device=dev)
        for s in range(0, n, q_chunk):
            e = min(n, s + q_chunk)
            sc = torch.matmul(q[:, s:e], kr[:, :start + e].transpose(-1, -2)) * hd ** -0.5
            causal = (torch.arange(start + e, device=dev)[None]
                      <= torch.arange(start + s, start + e, device=dev)[:, None])
            sc = torch.where(causal, sc, float("-inf"))
            ctx[:, s:e] = torch.matmul(torch.softmax(sc, -1), vr[:, :start + e])
        del kr, vr
        x = x + _linear(ctx.transpose(0, 1).reshape(n, H * hd), p.o_proj.weight)
        h = _rms(x, p.mlp_norm.weight, g.rms_eps)
        x = x + _linear(F.silu(_linear(h, p.gate_proj.weight)) * _linear(h, p.up_proj.weight),
                        p.down_proj.weight)
    return x, kv_out


def _head(model: QAModel, x: torch.Tensor) -> torch.Tensor:
    x = _rms(x, model.llm.final_norm.weight, model.llm.g.rms_eps)
    return _linear(x, model.llm.lm_head.weight)


@torch.no_grad()
def logits_at(model: QAModel, ids: List[int], img_pos: List[int], img_tokens: torch.Tensor,
              rows: List[int], q_chunk: int = 1024) -> torch.Tensor:
    """f32 logits [len(rows), vocab] of a causal forward over ``ids`` with
    the image positions holding ``img_tokens``."""
    x = _embed(model, ids, img_pos, img_tokens, img_tokens.device)
    x, _ = _layers(model, x, 0, None, q_chunk)
    return _head(model, x[torch.tensor(rows, device=x.device)])


@torch.no_grad()
def answer_gaps(model: QAModel, tok, items, image_tokens: int,
                control: Optional[bool] = False):
    """Per item (video key, uint8 tiles [n, S, S, 3], question, served
    tokens), per served token: how far its reference logit lies below the
    reference's best at its position; with ``control`` the token scored is
    the one the float8 reference puts first at each position instead.
    Items about the same video share their prompt's prefix (the system
    prompt and the frames), which runs once per video and precision.
    Returns (the gaps of each item in order, the prompt length of each)."""
    out: List[Optional[torch.Tensor]] = [None] * len(items)
    lengths = [0] * len(items)
    by_video = {}
    for i, it in enumerate(items):
        by_video.setdefault(it[0], []).append(i)
    for idx in by_video.values():
        tiles = items[idx[0]][1]
        dev = tiles.device
        pre, pos = prompt_prefix(tok, tiles.shape[0], image_tokens)
        P = len(pre)

        def prefix():
            x = _embed(model, pre, pos, vision_tokens(model.vision, tiles), dev)
            return _layers(model, x, 0, None)[1]

        def logits(past, seq, rows):
            x, _ = _layers(model, _embed(model, seq[P:], [], None, dev), P, past)
            return _head(model, x[torch.tensor([r - P for r in rows], device=dev)])

        past = prefix()
        if control:
            with Float8Products():
                past_low = prefix()
        for i in idx:
            _, _, question, served = items[i]
            ids = pre + prompt_tail(tok, question)
            seq = ids + list(served[:-1])
            rows = list(range(len(ids) - 1, len(seq)))
            ref = logits(past, seq, rows)
            if control:
                with Float8Products():
                    chosen = logits(past_low, seq, rows).argmax(-1)
            else:
                chosen = torch.tensor(served, device=dev)
            best = ref.max(-1).values
            out[i] = (best - ref.gather(-1, chosen[:, None])[:, 0]).cpu()
            lengths[i] = len(ids)
        del past
        if control:
            del past_low
    return out, lengths
