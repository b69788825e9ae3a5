"""Sinusoidal position encodings (counterpart of
``vgqa_tpu/ops/position_encoding.py``). All are computed in float32 from
masks or static lengths."""

from __future__ import annotations

import math

import torch


def _interleave_sin_cos(x: torch.Tensor) -> torch.Tensor:
    """sin of the even channels and cos of the odd ones, pairwise
    interleaved (the ``stack(...).flatten(-2)`` idiom)."""
    sin = torch.sin(x[..., 0::2])
    cos = torch.cos(x[..., 1::2])
    return torch.stack([sin, cos], dim=-1).flatten(-2)


def _sine_2d(pixel_mask, num_pos_feats, temp_h, temp_w, normalize, scale):
    if scale is None:
        scale = 2 * math.pi
    not_mask = pixel_mask.float()
    y_embed = torch.cumsum(not_mask, dim=-2)
    x_embed = torch.cumsum(not_mask, dim=-1)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[..., -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[..., :, -1:] + eps) * scale
    idx = torch.arange(num_pos_feats, dtype=torch.float32,
                       device=pixel_mask.device)
    expo = 2 * torch.floor(idx / 2) / num_pos_feats
    pos_x = _interleave_sin_cos(x_embed[..., None] / temp_w ** expo)
    pos_y = _interleave_sin_cos(y_embed[..., None] / temp_h ** expo)
    return torch.cat([pos_y, pos_x], dim=-1)


def sine_position_2d(
    pixel_mask: torch.Tensor,
    num_pos_feats: int = 128,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """2D sine embedding over a ``[..., H, W]`` validity mask (True = valid).

    Returns ``[..., H, W, 2*num_pos_feats]``, y-embed then x-embed."""
    return _sine_2d(pixel_mask, num_pos_feats, temperature, temperature,
                    normalize, scale)


def sine_position_hw_2d(
    pixel_mask: torch.Tensor,
    num_pos_feats: int = 128,
    temperature_h: float = 20.0,
    temperature_w: float = 20.0,
    normalize: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """2D sine embedding with separate H/W temperatures (POS_ENC sineHW)."""
    return _sine_2d(pixel_mask, num_pos_feats, temperature_h, temperature_w,
                    normalize, scale)


def sine_position_1d(length: int, d_model: int, device=None) -> torch.Tensor:
    """1D sequence sine embedding ``[length, d_model]``: even channels sin,
    odd channels cos, one log-spaced frequency ladder."""
    position = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    div_term = torch.exp(
        torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / d_model)
    )
    te = torch.zeros((length, d_model), dtype=torch.float32, device=device)
    te[:, 0::2] = torch.sin(position * div_term)
    te[:, 1::2] = torch.cos(position * div_term)
    return te


def box_sine_embedding(pos: torch.Tensor, num_feats: int = 128) -> torch.Tensor:
    """Sine embedding of box anchors ``[..., 2 or 4]`` in [0, 1], ordered
    (y, x[, w, h]); returns ``[..., num_feats * pos.shape[-1]]`` in float32."""
    scale = 2 * math.pi
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=pos.device)
    dim_t = 10000.0 ** (2 * torch.floor(dim_t / 2) / num_feats)
    pos = pos.float()

    def embed(coord):
        return _interleave_sin_cos(coord[..., None] * scale / dim_t)

    parts = [embed(pos[..., 1]), embed(pos[..., 0])]
    if pos.shape[-1] == 4:
        parts += [embed(pos[..., 2]), embed(pos[..., 3])]
    elif pos.shape[-1] != 2:
        raise ValueError(f"Unknown anchor dim {pos.shape[-1]}")
    return torch.cat(parts, dim=-1)

