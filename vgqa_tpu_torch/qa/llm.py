"""Decoder-only LLM of the VideoQA path (InternLM2.5 / Llama family).

Counterpart of ``vgqa_tpu/qa/llm.py`` (config, rotary positions, RMSNorm,
KV cache layouts) and ``vgqa_tpu/qa/llm_functional.py`` (``llm_forward``
over bf16, int8 or int4 weights). The JAX package runs the forward as a pure
function over a parameter tree; here it is an ``nn.Module`` whose seven
projections per layer and ``lm_head`` are linear modules of one of three
weight forms (``qa/quant.py``): ``DenseLinear`` (``weight`` [out, in]),
``Int8Linear`` (``kernel_q`` int8 [in, out] + ``scale`` [out]) or
``Int4Linear`` (``kernel_q4`` int8 [in/2, out] + ``scale4`` [in/g, out]).
Module and buffer names equal the flax tree's, so a JAX tree of any form
converts with ``models/convert_jax.state_dict_from_jax`` and loads through
:func:`load_llm_state`.

KV caches are lists with one entry per layer: ``(k, v)`` bf16 pairs
``[B, KVH, S, hd]``, or int8 dicts ``{kq, ks, vq, vs}`` with one f32 absmax
scale per token-head vector. The forward writes the new K/V into the cache
tensors in place (JAX's functional update returns new buffers; the port
saves the copy) and returns the list. The stacked layouts of the JAX
package (``VGQA_STACKED_KV``, the scanned decode) are not ported.

Differences from the JAX arithmetic, all of which the CPU parity tests
cover in float32: the rotary product is cast back to the activation dtype
(JAX promotes bf16 activations to f32 there), so q and k stay bf16 for the
K5 kernel on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import torch
from torch import nn

from .quant import DenseLinear, Int4Linear, Int8Linear

Cache = List[Any]


@dataclass(frozen=True)
class LLMConfig:
    vocab_size: int = 92553           # InternLM2.5-7B vocab
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    intermediate_size: int = 14336
    rope_theta: float = 1000000.0
    rms_eps: float = 1e-5
    max_seq_len: int = 16384
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def internlm2_5_7b(cls) -> "LLMConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "LLMConfig":
        return cls(
            vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
            num_kv_heads=2, intermediate_size=128, max_seq_len=512,
            rope_theta=10000.0,
        )


def rotary_embedding(positions: torch.Tensor, head_dim: int, theta: float):
    """cos/sin tables [..., head_dim/2] (f32) for integer ``positions`` [...]."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                             device=positions.device) / head_dim))
    angles = positions[..., None].float() * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Split-half rotary: x [..., L, H, D]; cos/sin [..., L, D/2] broadcast
    over heads. Computed in f32, returned in x's dtype."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the JAX cast order: normalise in f32, cast, then scale
        var = x.float().square().mean(-1, keepdim=True)
        return (x.float() * torch.rsqrt(var + self.eps)).to(x.dtype) * self.weight


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        c = cfg
        kv = c.num_kv_heads * c.head_dim
        self.attn_norm = RMSNorm(c.hidden_size, c.rms_eps)
        self.q_proj = DenseLinear(c.hidden_size, c.num_heads * c.head_dim)
        self.k_proj = DenseLinear(c.hidden_size, kv)
        self.v_proj = DenseLinear(c.hidden_size, kv)
        self.o_proj = DenseLinear(c.num_heads * c.head_dim, c.hidden_size)
        self.mlp_norm = RMSNorm(c.hidden_size, c.rms_eps)
        self.gate_proj = DenseLinear(c.hidden_size, c.intermediate_size)
        self.up_proj = DenseLinear(c.hidden_size, c.intermediate_size)
        self.down_proj = DenseLinear(c.intermediate_size, c.hidden_size)


def init_kv_cache(cfg: LLMConfig, batch: int, max_len: int, dtype=torch.bfloat16,
                  quant: Optional[str] = None, device=None) -> Cache:
    """Per-layer list cache: ``(k, v)`` pairs [B, KVH, S, hd] in ``dtype``,
    or with ``quant="int8"`` dicts {kq int8 [B, KVH, S, hd], ks f32
    [B, KVH, S], vq, vs}."""
    kv = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    if quant == "int8":
        sc = kv[:3]
        return [{"kq": torch.zeros(kv, dtype=torch.int8, device=device),
                 "ks": torch.zeros(sc, dtype=torch.float32, device=device),
                 "vq": torch.zeros(kv, dtype=torch.int8, device=device),
                 "vs": torch.zeros(sc, dtype=torch.float32, device=device)}
                for _ in range(cfg.num_layers)]
    if quant is not None:
        raise ValueError(f"unknown KV quantization {quant!r}")
    return [(torch.zeros(kv, dtype=dtype, device=device),
             torch.zeros(kv, dtype=dtype, device=device)) for _ in range(cfg.num_layers)]


def quantize_kv(t: torch.Tensor):
    """Absmax int8 along the last axis: [..., hd] -> (int8 [..., hd], f32
    scale [...]); all-zero vectors get the floor scale 1e-6 / 127."""
    t32 = t.float()
    s = t32.abs().amax(-1).clamp_min(1e-6) / 127.0
    q = torch.round(t32 / s[..., None]).clamp(-127, 127)
    return q.to(torch.int8), s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_kv`."""
    return (q.float() * s[..., None]).to(dtype)


def quantize_kv_cache(cache: Cache) -> Cache:
    """bf16 per-layer list cache -> the int8 dict layout, one layer at a time
    (each bf16 layer is dropped from the list as its int8 copy is made)."""
    out = []
    for i in range(len(cache)):
        ck, cv = cache[i]
        cache[i] = None
        out.append(dict(zip(("kq", "ks", "vq", "vs"), quantize_kv(ck) + quantize_kv(cv))))
    return out


def kv_cache_quantized(cache) -> bool:
    """True for the int8 per-layer dict layout."""
    return isinstance(cache, (list, tuple)) and len(cache) > 0 and isinstance(cache[0], dict)


def kv_seq_len(cache) -> int:
    """Sequence capacity S of a cache."""
    if kv_cache_quantized(cache):
        return cache[0]["kq"].shape[2]
    return cache[0][0].shape[2]


def _write(buf: torch.Tensor, upd: torch.Tensor, start: Union[int, torch.Tensor]) -> None:
    """``buf[b, :, start_b : start_b + L] = upd[b]`` in place, with JAX's
    dynamic_update_slice clamp of the start to [0, S - L]. ``start`` is a
    host int, a device scalar, or a [B] vector (batched decode: each row at
    its own position)."""
    S, L = buf.shape[2], upd.shape[2]
    upd = upd.to(buf.dtype)
    if isinstance(start, int):
        s = min(max(start, 0), S - L)
        buf[:, :, s:s + L] = upd
        return
    ar = torch.arange(L, device=buf.device)
    start = start.to(buf.device)
    if start.dim() == 0:
        buf.index_copy_(2, start.clamp(0, S - L) + ar, upd)
        return
    idx = start.clamp(0, S - L)[:, None] + ar[None]                       # [B, L]
    rows = torch.arange(buf.shape[0], device=buf.device)[:, None]
    buf[rows, :, idx] = upd.transpose(1, 2)


class LLM(nn.Module):
    """The decoder stack + final norm + lm_head (no embedding: the engine
    splices vision tokens into the embedded prompt)."""

    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(cfg))
        self.final_norm = RMSNorm(cfg.hidden_size, cfg.rms_eps)
        self.lm_head = DenseLinear(cfg.hidden_size, cfg.vocab_size)

    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.cfg.num_layers)]

    def forward(
        self,
        input_embeds: torch.Tensor,              # [B, L, D]
        positions: torch.Tensor,                 # [B, L]
        attn_mask: torch.Tensor,                 # [B, L, S] True = attend
        cache: Optional[Cache] = None,
        cache_index: Union[int, torch.Tensor, None] = None,
        lm_head_rows: Optional[torch.Tensor] = None,   # [B]
        flash_prefill: Optional[Dict[str, Any]] = None,
        w8a8: bool = False,
        kernels: bool = True,
        collect_act_stats: bool = False,
    ):
        """Port of ``llm_forward`` (llm_functional.py:90).

        ``cache_index``: a host int or device scalar (every row writes at the
        same offset: prefill) or a [B] vector (batched decode). ``lm_head_rows``
        restricts the head to one row per batch element (logits [B, 1, V]).
        ``w8a8`` runs int8 projections with per-row int8 activations.
        ``flash_prefill`` = {"q_offset": host int, "length": device scalar}
        routes the attention through K5 (``attn_mask`` is then ignored; B
        must be 1). ``kernels`` routes decode-sized int4 products to K6.
        Returns (logits, cache); with ``collect_act_stats`` also the
        SmoothQuant calibration statistics, ``{layer_i: {qkv_in, o_in,
        mlp_in, down_in}}``: the f32 absmax over all tokens of each input
        channel of the qkv, o, gate/up and down projections."""
        cfg = self.cfg
        x = input_embeds
        B, L, _ = x.shape
        hd = cfg.head_dim
        group = cfg.num_heads // cfg.num_kv_heads

        def proj(mod, t, w8: bool = w8a8):
            return mod(t, kernels=kernels) if isinstance(mod, Int4Linear) else mod(t, w8)

        cos, sin = rotary_embedding(positions, hd, cfg.rope_theta)
        new_cache: Cache = []
        act_stats: Dict[str, Dict[str, torch.Tensor]] = {}
        for i, p in enumerate(self.layers()):
            h = p.attn_norm(x)
            q = proj(p.q_proj, h).reshape(B, L, cfg.num_heads, hd)
            k = proj(p.k_proj, h).reshape(B, L, cfg.num_kv_heads, hd)
            v = proj(p.v_proj, h).reshape(B, L, cfg.num_kv_heads, hd)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
            k_t, v_t = k.transpose(1, 2), v.transpose(1, 2)       # [B, KVH, L, hd]

            ent = None
            if cache is not None and isinstance(cache[i], dict):
                # int8 KV: quantize this step's vectors at write time
                ent = cache[i]
                kq, ks = quantize_kv(k_t)
                vq, vs = quantize_kv(v_t)
                for name, t in (("kq", kq), ("ks", ks), ("vq", vq), ("vs", vs)):
                    _write(ent[name], t, cache_index)
                keys = values = None
                new_cache.append(ent)
            elif cache is not None:
                keys, values = cache[i]
                _write(keys, k_t, cache_index)
                _write(values, v_t, cache_index)
                new_cache.append((keys, values))
            else:
                keys, values = k_t.contiguous(), v_t.contiguous()
                new_cache.append((keys, values))

            if flash_prefill is not None:
                from ..ops.kernels.flash_attention import flash_gqa_causal

                if B != 1:
                    raise ValueError("flash prefill is single-sequence")
                if ent is not None:
                    keys = dequantize_kv(ent["kq"], ent["ks"], x.dtype)
                    values = dequantize_kv(ent["vq"], ent["vs"], x.dtype)
                ctxf = flash_gqa_causal(q[0].transpose(0, 1), keys[0], values[0],
                                        q_offset=flash_prefill["q_offset"],
                                        length=flash_prefill["length"])
                ctx = ctxf.transpose(0, 1).reshape(1, L, cfg.num_heads * hd).to(x.dtype)
            else:
                ctx = _attention(q, keys, values, ent, attn_mask, group, x.dtype)
            x = x + proj(p.o_proj, ctx)

            h2 = p.mlp_norm(x)
            m = torch.nn.functional.silu(proj(p.gate_proj, h2)) * proj(p.up_proj, h2)
            x = x + proj(p.down_proj, m)
            if collect_act_stats:
                act_stats[f"layer_{i}"] = {"qkv_in": _absmax(h), "o_in": _absmax(ctx),
                                           "mlp_in": _absmax(h2), "down_in": _absmax(m)}

        x = self.final_norm(x)
        if lm_head_rows is not None:
            x = x[torch.arange(B, device=x.device), lm_head_rows.to(x.device)][:, None]
        # the head never takes W8A8 activations (llm_functional.py:330)
        logits = proj(self.lm_head, x, w8=False)
        if collect_act_stats:
            return logits, new_cache, act_stats
        return logits, new_cache


def _absmax(t: torch.Tensor) -> torch.Tensor:
    """Per-channel absmax over every token (the last axis kept), in f32."""
    return t.float().abs().reshape(-1, t.shape[-1]).amax(0)


def _attention(q, keys, values, ent, attn_mask, group: int, dtype) -> torch.Tensor:
    """The einsum attention of ``llm_forward`` (bf16 cache, or int8 cache
    with the per-token scales factored out of both dots)."""
    B, L, H, hd = q.shape
    KVH = H // group
    # the group's query heads stack on the row axis: [B, KVH, group*L, hd]
    # against [B, KVH, S, hd], so no KV head is broadcast or copied
    qh = q.transpose(1, 2).reshape(B, KVH, group * L, hd).float()
    mask = attn_mask[:, None].repeat(1, 1, group, 1)                 # [B, 1, group*L, S]
    if ent is not None:
        logits = torch.matmul(qh, ent["kq"].float().transpose(-1, -2)) * ent["ks"][:, :, None, :]
        logits = torch.where(mask, logits / hd ** 0.5, -1e30)
        probs = torch.softmax(logits, dim=-1)
        pv = (probs * ent["vs"][:, :, None, :]).to(dtype)
        ctx = torch.matmul(pv.float(), ent["vq"].float()).to(dtype)
    else:
        logits = torch.matmul(qh, keys.float().transpose(-1, -2)) / hd ** 0.5
        logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(dtype)
        ctx = torch.matmul(probs.float(), values.float()).to(dtype)
    return ctx.reshape(B, H, L, hd).transpose(1, 2).reshape(B, L, H * hd)


class TokenEmbedding(nn.Module):
    def __init__(self, cfg: LLMConfig):
        super().__init__()
        self.cfg = cfg
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.tok_embeddings(token_ids.clamp(0, self.cfg.vocab_size - 1))


def load_llm_state(llm: LLM, state: Dict[str, torch.Tensor]) -> LLM:
    """Load a state dict whose projections may be of any weight form: each
    linear whose entries name ``kernel_q`` / ``kernel_q4`` becomes an
    ``Int8Linear`` / ``Int4Linear`` of the stored shapes first. Strict: a
    missing or unmapped entry raises."""
    norm = llm.final_norm.weight
    for name, mod in list(llm.named_modules()):
        if not isinstance(mod, (DenseLinear, Int8Linear, Int4Linear)):
            continue
        if f"{name}.kernel_q4" in state:
            form = (Int4Linear, state[f"{name}.kernel_q4"], state[f"{name}.scale4"])
        elif f"{name}.kernel_q" in state:
            form = (Int8Linear, state[f"{name}.kernel_q"], state[f"{name}.scale"])
        elif f"{name}.weight" in state:
            w = state[f"{name}.weight"]
            form = (DenseLinear, w.shape[1], w.shape[0])
        else:
            continue        # load_state_dict reports the missing entry
        if type(mod) is form[0]:
            continue
        new = form[0](*form[1:]).to(norm.device)
        if isinstance(new, DenseLinear):
            new = new.to(norm.dtype)
        parent, _, leaf = name.rpartition(".")
        setattr(llm.get_submodule(parent) if parent else llm, leaf, new)
    llm.load_state_dict(state, strict=True)
    return llm
