"""InternViT-style vision encoder + pixel-shuffle projector.

Counterpart of ``vgqa_tpu/qa/vit.py``: a plain ViT over 448 px tiles (patch
14 -> 32 x 32 tokens + CLS) whose patch tokens are pixel-unshuffled 2x
(-> 16 x 16 = 256 tokens per tile) and projected by an MLP into the LLM's
embedding space. Tiles are NHWC ``[B, S, S, 3]`` as in the JAX package.
With ``forward(..., flash=True)`` the attention runs ``flash_mha`` (K4 on
the card) on q/k/v sliced from the fused qkv projection; with
``flash=False``, the einsum core of ``ops/attention.py``. The JAX config's
``flash`` field becomes that argument. Module names equal the flax names.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from ..ops.attention import dot_product_attention


@dataclass(frozen=True)
class ViTConfig:
    image_size: int = 448
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    llm_hidden_size: int = 4096
    downsample_ratio: float = 0.5
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @classmethod
    def internvit_300m(cls) -> "ViTConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "ViTConfig":
        return cls(image_size=32, patch_size=8, hidden_size=32, num_layers=2,
                   num_heads=4, intermediate_size=64, llm_hidden_size=64)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c = cfg
        self.num_heads = c.num_heads
        self.norm1 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.qkv = nn.Linear(c.hidden_size, 3 * c.hidden_size, bias=c.qkv_bias)
        self.proj = nn.Linear(c.hidden_size, c.hidden_size)
        self.ls1 = nn.Parameter(torch.ones(c.hidden_size))
        self.norm2 = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.fc1 = nn.Linear(c.hidden_size, c.intermediate_size)
        self.fc2 = nn.Linear(c.intermediate_size, c.hidden_size)
        self.ls2 = nn.Parameter(torch.ones(c.hidden_size))

    def forward(self, x: torch.Tensor, flash: bool = True) -> torch.Tensor:
        h = self.norm1(x)
        q, k, v = self.qkv(h).chunk(3, dim=-1)
        if flash:
            from ..ops.kernels.flash_attention import flash_mha

            attn = flash_mha(q, k, v, self.num_heads)
        else:
            attn = dot_product_attention(q, k, v, self.num_heads)
        x = x + self.proj(attn) * self.ls1
        h = torch.nn.functional.gelu(self.fc1(self.norm2(x)), approximate="none")
        return x + self.fc2(h) * self.ls2


def pixel_shuffle_tokens(x: torch.Tensor, ratio: float) -> torch.Tensor:
    """[B, H, W, C] -> [B, H*r, W*r, C/r^2] token downsample (InternVL)."""
    B, H, W, C = x.shape
    r = int(1 / ratio)
    x = x.reshape(B, H // r, r, W // r, r, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H // r, W // r, C * r * r)


class VisionTower(nn.Module):
    """ViT + pixel shuffle + 2-layer MLP projector -> LLM token embeddings:
    tiles [B, S, S, 3] -> [B, (grid * ratio)^2, llm_hidden]."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        c = cfg
        self.cfg = cfg
        g = c.grid
        self.patch_embed = nn.Conv2d(3, c.hidden_size, c.patch_size, stride=c.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, c.hidden_size))
        self.pos_embed = nn.Parameter(torch.zeros(1, g * g + 1, c.hidden_size))
        for i in range(c.num_layers):
            self.add_module(f"block_{i}", ViTBlock(c))
        mixed = int(c.hidden_size / c.downsample_ratio ** 2)
        # mlp1's LayerNorm uses torch's default eps (1e-5), not the trunk's
        self.proj_norm = nn.LayerNorm(mixed, eps=1e-5)
        self.proj_fc1 = nn.Linear(mixed, c.llm_hidden_size)
        self.proj_fc2 = nn.Linear(c.llm_hidden_size, c.llm_hidden_size)

    def forward(self, tiles: torch.Tensor, flash: bool = True) -> torch.Tensor:
        c = self.cfg
        B = tiles.shape[0]
        g = c.grid
        x = self.patch_embed(tiles.permute(0, 3, 1, 2))             # [B, D, g, g]
        x = x.flatten(2).transpose(1, 2)                             # [B, g*g, D]
        x = torch.cat([self.cls_token.expand(B, 1, -1).to(x.dtype), x], dim=1)
        x = x + self.pos_embed
        for i in range(c.num_layers):
            x = getattr(self, f"block_{i}")(x, flash)
        patch = x[:, 1:].reshape(B, g, g, c.hidden_size)
        shuffled = pixel_shuffle_tokens(patch, c.downsample_ratio)
        gg = shuffled.shape[1]
        tokens = shuffled.reshape(B, gg * gg, shuffled.shape[-1])
        h = torch.nn.functional.gelu(self.proj_fc1(self.proj_norm(tokens)),
                                     approximate="none")
        return self.proj_fc2(h)
