"""Seeded random initialization of the port's modules (the weights of a
model built without a checkpoint)."""

from __future__ import annotations

import torch
from torch import nn

from .layers import LearnedPosition2D
from .video_swin import VideoSwinBackbone, WindowAttention3D


def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Seeded random initialization with flax-like scales: linear and conv
    weights N(0, 1/fan_in), zero biases, unit norms, N(0, 1/dim) embeddings,
    and each raw parameter at the scale of its JAX initializer."""

    def normal_(t, std):
        with torch.no_grad():
            t.copy_(torch.randn(t.shape, generator=generator) * std)

    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            normal_(m.weight, m.weight[0].numel() ** -0.5)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Embedding):
            normal_(m.weight, m.weight.shape[1] ** -0.5)
        elif isinstance(m, WindowAttention3D):
            normal_(m.relative_position_bias_table, 0.02)
        elif isinstance(m, VideoSwinBackbone):
            normal_(m.patch_embed_kernel, m.patch_embed_kernel[0, ..., 0].numel() ** -0.5)
        elif isinstance(m, LearnedPosition2D):
            with torch.no_grad():
                m.row_embed.copy_(torch.rand(m.row_embed.shape, generator=generator))
                m.col_embed.copy_(torch.rand(m.col_embed.shape, generator=generator))
    if hasattr(model, "ground_decoder") and hasattr(model.ground_decoder, "time_embed"):
        normal_(model.ground_decoder.time_embed, 1.0)
