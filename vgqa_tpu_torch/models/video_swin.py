"""Video Swin Transformer 3D (counterpart of the parameter tree of
``vgqa_tpu/models/video_swin.py:VideoSwinBackbone`` and of its kernel
forward ``fused_backbone_apply``).

Layout is channels-last ``[B, D, H, W, C]``. The forward pads each stage once
to window multiples and runs every block through ``swin_block_canvas`` on
that canvas: the block reads windows of ``roll(canvas, -shift)`` and writes
in the rolled frame, consecutive blocks' rolls compose, and the frame
unrolls once at the stage end. Training passes DropPath branch gates
``[blocks, B, 2]`` (0 or 1/keep per sample and branch); the tower is frozen
there and runs without gradient, as the JAX package runs its kernel path
(the kernel has no backward). A tower that trains runs the blocks' plain
version, which autograd differentiates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.swin_block import swin_block_canvas, swin_block_canvas_reference

Tuple3 = Tuple[int, int, int]


def _adjust_window(dims: Tuple3, window: Tuple3, shift: Tuple3):
    """Clamp the window to the input extent and drop the shift where the
    window covers it."""
    w, s = list(window), list(shift)
    for i in range(3):
        if dims[i] <= window[i]:
            w[i] = dims[i]
            s[i] = 0
    return tuple(w), tuple(s)


def _relative_position_index(window: Tuple3, device=None) -> torch.Tensor:
    """Pairwise relative-position bias index [N, N]."""
    wd, wh, ww = window
    flat = torch.arange(wd * wh * ww, device=device)
    d = flat // (wh * ww)
    h = (flat // ww) % wh
    w = flat % ww

    def rel(c, extent):
        return c[:, None] - c[None, :] + (extent - 1)

    return (rel(d, wd) * (2 * wh - 1) * (2 * ww - 1)
            + rel(h, wh) * (2 * ww - 1) + rel(w, ww))


def _region_ids(extent: int, window: int, shift: int) -> np.ndarray:
    """Per-coordinate SW-MSA region id along one axis (0/1/2)."""
    idx = np.arange(extent)
    if shift == 0:
        return np.zeros((extent,), np.int32)
    return np.where(idx < extent - window, 0,
                    np.where(idx < extent - shift, 1, 2)).astype(np.int32)


def _to_windows(v: np.ndarray, window: Tuple3) -> np.ndarray:
    Dp, Hp, Wp = v.shape
    wd, wh, ww = window
    v = v.reshape(Dp // wd, wd, Hp // wh, wh, Wp // ww, ww)
    return v.transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)


def _region_partition(dims_padded: Tuple3, window: Tuple3, shift: Tuple3) -> np.ndarray:
    """SW-MSA region ids per window: [nW, N] int32."""
    Dp, Hp, Wp = dims_padded
    wd, wh, ww = window
    region = (_region_ids(Dp, wd, shift[0])[:, None, None] * 9
              + _region_ids(Hp, wh, shift[1])[None, :, None] * 3
              + _region_ids(Wp, ww, shift[2])[None, None, :])
    return _to_windows(region, window)


def _valid_partition(dims: Tuple3, dims_padded: Tuple3, window: Tuple3,
                     shift: Tuple3) -> Optional[np.ndarray]:
    """Per-window validity (1 = real token, 0 = pad) in rolled coordinates,
    or None when the canvas has no padding."""
    D, H, W = dims
    Dp, Hp, Wp = dims_padded
    if (D, H, W) == (Dp, Hp, Wp):
        return None
    v = ((np.arange(Dp) < D)[:, None, None] & (np.arange(Hp) < H)[None, :, None]
         & (np.arange(Wp) < W)[None, None, :]).astype(np.float32)
    if any(shift):
        v = np.roll(v, shift=(-shift[0], -shift[1], -shift[2]), axis=(0, 1, 2))
    return _to_windows(v, window)


@dataclass(frozen=True)
class VideoSwinConfig:
    patch_size: Tuple3 = (1, 4, 4)
    embed_dim: int = 96
    depths: Sequence[int] = (2, 2, 6, 2)
    num_heads: Sequence[int] = (3, 6, 12, 24)
    window: Tuple3 = (8, 7, 7)
    mlp_ratio: float = 4.0
    drop_path_rate: float = 0.2
    patch_norm: bool = True

    @classmethod
    def tiny_test(cls) -> "VideoSwinConfig":
        return cls(embed_dim=8, depths=(1, 1, 1, 1), num_heads=(2, 2, 2, 2),
                   window=(2, 2, 2), drop_path_rate=0.0)


VIDEO_SWIN_CONFIGS: Dict[str, VideoSwinConfig] = {
    "video_swin_t_p4w7": VideoSwinConfig(),
    "video_swin_s_p4w7": VideoSwinConfig(depths=(2, 2, 18, 2)),
    "video_swin_b_p4w7": VideoSwinConfig(
        embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
    "video_swin_test": VideoSwinConfig.tiny_test(),
}


class WindowAttention3D(nn.Module):
    """Parameters of one block's attention: qkv, proj and the relative
    position bias table sized for the full configured window."""

    def __init__(self, dim: int, window: Tuple3, num_heads: int):
        super().__init__()
        wd, wh, ww = window
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)


class SwinBlock3D(nn.Module):
    """Parameters of one (shifted-)window block."""

    def __init__(self, dim: int, num_heads: int, window: Tuple3, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention3D(dim, window, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)


class PatchMerging(nn.Module):
    """2x spatial downsample: concat 2x2 neighbours, LN, linear 4C -> 2C."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, D, H, W, C = x.shape
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2],
                       x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class VideoSwinBackbone(nn.Module):
    """Per-frame pyramid features: [B, T, H, W, 3] -> {'0'..'3'} of
    [B, T, H/4/2^i, W/4/2^i, C_i], stage outputs taken before each
    downsample.

    ``use_kernels`` selects ``swin_block_canvas`` (the kernel on CUDA, its
    plain version on the CPU); off, every block runs the plain version."""

    def __init__(self, cfg: VideoSwinConfig = VideoSwinConfig(), use_kernels: bool = True):
        super().__init__()
        self.cfg = c = cfg
        self.use_kernels = use_kernels
        pd, ph, pw = c.patch_size
        if pd != 1:
            raise ValueError("patch_size[0] must be 1 (per-frame temporal resolution)")
        self.patch_embed_kernel = nn.Parameter(torch.empty(pd, ph, pw, 3, c.embed_dim))
        nn.init.normal_(self.patch_embed_kernel, std=(ph * pw * 3) ** -0.5)
        self.patch_embed_bias = nn.Parameter(torch.zeros(c.embed_dim))
        if c.patch_norm:
            self.patch_norm = nn.LayerNorm(c.embed_dim, eps=1e-5)
        for stage, depth in enumerate(c.depths):
            dim = c.embed_dim * 2**stage
            for b in range(depth):
                setattr(self, f"stage{stage}_block{b}", SwinBlock3D(
                    dim, c.num_heads[stage], c.window, c.mlp_ratio))
            if stage < len(c.depths) - 1:
                setattr(self, f"downsample{stage}", PatchMerging(dim))

    def _block_bias(self, blk: SwinBlock3D, n: int, heads: int) -> torch.Tensor:
        """[H, N, N] rel-pos bias of one block at window size N."""
        table = blk.attn.relative_position_bias_table
        index = _relative_position_index(self.cfg.window, table.device)[:n, :n]
        bias = table[index.reshape(-1)].reshape(n, n, heads)
        return bias.permute(2, 0, 1).contiguous()

    def drop_path_gates(self, rng, batch: int, device) -> Optional[torch.Tensor]:
        """DropPath branch gates [blocks, batch, 2] for one training step:
        keep = 1 - linspace(0, drop_path_rate, blocks), Bernoulli(keep) /
        keep (the JAX package's sampling); None when the rate is 0."""
        c = self.cfg
        if c.drop_path_rate <= 0:
            return None
        total = sum(c.depths)
        keep = torch.from_numpy(1.0 - np.linspace(0.0, c.drop_path_rate, total)).float()
        keep = keep.to(device)[:, None, None].expand(total, batch, 2)
        return rng.bernoulli(keep).float() / keep

    def forward(self, frames: torch.Tensor, gates: Optional[torch.Tensor] = None,
                use_kernels: Optional[bool] = None) -> Dict[str, torch.Tensor]:
        """``gates`` [blocks, B, 2] DropPath branch gates (training);
        ``use_kernels`` overrides the module's route for this call."""
        c = self.cfg
        _, ph, pw = c.patch_size
        B, T, H, W, _ = frames.shape
        gh, gw = H // ph, W // pw
        patches = frames.reshape(B, T, gh, ph, gw, pw, 3).permute(0, 1, 2, 4, 3, 5, 6)
        patches = patches.reshape(B, T, gh, gw, ph * pw * 3)
        kernel = self.patch_embed_kernel.reshape(ph * pw * 3, c.embed_dim)
        x = (torch.matmul(patches.float(), kernel.float()).to(frames.dtype)
             + self.patch_embed_bias)
        if c.patch_norm:
            x = self.patch_norm(x)

        if use_kernels is None:
            use_kernels = self.use_kernels
        block = swin_block_canvas if use_kernels else swin_block_canvas_reference
        out: Dict[str, torch.Tensor] = {}
        blk_base = 0
        for stage, depth in enumerate(c.depths):
            _, D_, H_, W_, _ = x.shape
            window, _ = _adjust_window((D_, H_, W_), c.window, (0, 0, 0))
            pads = ((-D_) % window[0], (-H_) % window[1], (-W_) % window[2])
            if any(pads):
                x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
            padded = (D_ + pads[0], H_ + pads[1], W_ + pads[2])
            N = window[0] * window[1] * window[2]
            frame = (0, 0, 0)
            for b in range(depth):
                shift = (0, 0, 0) if b % 2 == 0 else tuple(w // 2 for w in c.window)
                _, shift = _adjust_window((D_, H_, W_), c.window, shift)
                rel = tuple((s - f) % p for s, f, p in zip(shift, frame, padded))
                region = valid = None
                if any(shift):
                    region = torch.from_numpy(_region_partition(padded, window, shift)).to(x.device)
                v = _valid_partition((D_, H_, W_), padded, window, shift)
                if v is not None:
                    valid = torch.from_numpy(v).to(x.device)
                blk = getattr(self, f"stage{stage}_block{b}")
                x = block(
                    x, blk.norm1.weight, blk.norm1.bias,
                    blk.attn.qkv.weight.t(), blk.attn.qkv.bias,
                    blk.attn.proj.weight.t(), blk.attn.proj.bias,
                    blk.norm2.weight, blk.norm2.bias,
                    blk.mlp_fc1.weight.t(), blk.mlp_fc1.bias,
                    blk.mlp_fc2.weight.t(), blk.mlp_fc2.bias,
                    self._block_bias(blk, N, c.num_heads[stage]),
                    c.num_heads[stage], window, rel, region=region, valid=valid,
                    gates=None if gates is None else gates[blk_base + b],
                )
                frame = shift
            if any(frame):
                x = torch.roll(x, shifts=frame, dims=(1, 2, 3))
            x = x[:, :D_, :H_, :W_]
            blk_base += depth
            out[str(stage)] = x
            if stage < len(c.depths) - 1:
                x = getattr(self, f"downsample{stage}")(x)
        return out
