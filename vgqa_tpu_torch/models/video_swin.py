"""Video Swin Transformer 3D (counterpart of
``vgqa_tpu/models/video_swin.py``: the modules ``WindowAttention3D``,
``DropPath``, ``SwinBlock3D`` and ``VideoSwinBackbone``, and the kernel
forwards ``fused_block_apply`` and ``fused_backbone_apply``).

Layout is channels-last ``[B, D, H, W, C]``. ``VideoSwinBackbone.forward``
takes one of three routes through the blocks:

* ``"canvas"`` (the default; the counterpart of ``fused_backbone_apply``)
  pads each stage once to window multiples and runs every block through
  ``swin_block_canvas`` on that canvas: the block reads windows of
  ``roll(canvas, -shift)`` and writes in the rolled frame, consecutive
  blocks' rolls compose, and the frame unrolls once at the stage end.
  Training passes DropPath branch gates ``[blocks, B, 2]`` (0 or 1/keep per
  sample and branch); the kernel has no backward, so this route runs
  without gradient, as the JAX package runs its kernel path for a frozen
  tower. ``use_kernels=False`` runs the blocks' plain version instead.
* ``"module"`` runs ``SwinBlock3D.forward`` per block (the flax module
  route): plain PyTorch that autograd differentiates, with DropPath drawn
  from the step's ``DropoutRng``. A trainable tower and serving with
  ``TPU.USE_PALLAS_ATTENTION False`` take it.
* ``"blocks"`` runs ``fused_block_apply`` per block (``swin_block_fused``
  on windows partitioned outside the kernel). The JAX package has no
  backbone-level route over that kernel and no config key selects this
  one: it drives the windowed kernel through the whole tower.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.dropout import DropoutRng
from ..ops.kernels.swin_block import (
    _partition,
    _reverse,
    swin_block_canvas,
    swin_block_canvas_reference,
    swin_block_fused,
)
from ..utils import trace

Tuple3 = Tuple[int, int, int]
ROUTES = ("canvas", "module", "blocks")


def _adjust_window(dims: Tuple3, window: Tuple3, shift: Tuple3):
    """Clamp the window to the input extent and drop the shift where the
    window covers it."""
    w, s = list(window), list(shift)
    for i in range(3):
        if dims[i] <= window[i]:
            w[i] = dims[i]
            s[i] = 0
    return tuple(w), tuple(s)


def window_partition(x: torch.Tensor, window: Tuple3) -> torch.Tensor:
    """[B, D, H, W, C] -> [B*nW, wd*wh*ww, C]"""
    return _partition(x, window)


def window_reverse(windows: torch.Tensor, window: Tuple3, B: int, D: int, H: int,
                   W: int) -> torch.Tensor:
    """[B*nW, wd*wh*ww, C] -> [B, D, H, W, C]"""
    return _reverse(windows, window, B, D, H, W)


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


def compute_shift_mask(dims_padded: Tuple3, window: Tuple3, shift: Tuple3,
                       device=None) -> Optional[torch.Tensor]:
    """SW-MSA region mask [nW, N, N] in f32: -100 between tokens of
    different regions, 0 within one; None without a shift."""
    if not any(shift):
        return None
    with trace.sync("swin.region"):
        region = torch.from_numpy(_region_partition(dims_padded, window, shift)).to(device)
    return (region[:, None, :] != region[:, :, None]).float() * -100.0


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
    """W-MSA with a learned relative position bias. ``window`` is the full
    configured window: the bias table is sized for it, and a window clamped
    to a smaller input reads the index's [:N, :N] corner."""

    def __init__(self, dim: int, window: Tuple3, num_heads: int):
        super().__init__()
        wd, wh, ww = window
        self.window, self.num_heads = tuple(window), num_heads
        self.relative_position_bias_table = nn.Parameter(torch.empty(
            (2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1), num_heads))
        nn.init.trunc_normal_(self.relative_position_bias_table, std=0.02)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def relative_position_bias(self, n: int) -> torch.Tensor:
        """[H, N, N] bias at window size N, in the table's dtype."""
        table = self.relative_position_bias_table
        index = _relative_position_index(self.window, table.device)[:n, :n]
        bias = table[index.reshape(-1)].reshape(n, n, self.num_heads)
        return bias.permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B_, N, C]; mask [nW, N, N] additive (B_ a multiple of nW) or None.

        The JAX rounding points: logits as an f32-accumulated product cast
        to the activation dtype, then scaled; bias and mask added in that
        dtype as separate broadcasts (a combined [nW, H, N, N] term would be
        ~1 GB at 64f@224); softmax in f32, probabilities cast back for P.V."""
        B_, N, C = x.shape
        H = self.num_heads
        hd = C // H
        dt = x.dtype
        q, k, v = self.qkv(x).split(C, dim=-1)

        def heads(t):
            return t.reshape(B_, N, H, hd).transpose(1, 2)

        logits = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * hd ** -0.5
        logits = logits + self.relative_position_bias(N).to(dt)[None]
        if mask is not None:
            nW = mask.shape[0]
            logits = (logits.reshape(B_ // nW, nW, H, N, N)
                      + mask.to(dt)[None, :, None]).reshape(B_, H, N, N)
        probs = torch.softmax(logits.float(), dim=-1).to(dt)
        out = torch.matmul(probs, heads(v)).transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)


class DropPath(nn.Module):
    """Per-sample stochastic depth: each sample's branch is kept with
    probability 1 - rate and scaled by 1 / keep, or zeroed."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        if deterministic or self.rate == 0.0:
            return x
        if rng is None:
            raise ValueError("a stochastic DropPath needs the step's DropoutRng")
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.dim() - 1)
        kept = rng.bernoulli(torch.full(shape, keep, device=x.device))
        return torch.where(kept, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


class SwinBlock3D(nn.Module):
    """One (shifted-)window block. ``window`` and ``shift`` are the
    configured ones; the forward clamps both to the input."""

    def __init__(self, dim: int, num_heads: int, window: Tuple3, shift: Tuple3 = (0, 0, 0),
                 mlp_ratio: float = 4.0, drop_path: float = 0.0):
        super().__init__()
        self.window, self.shift = tuple(window), tuple(shift)
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention3D(dim, window, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def kernel_weights(self):
        """LN1, qkv, proj, LN2, fc1, fc2 in the kernels' argument order, the
        linear weights as ``[in, out]`` views."""
        return (self.norm1.weight, self.norm1.bias,
                self.attn.qkv.weight.t(), self.attn.qkv.bias,
                self.attn.proj.weight.t(), self.attn.proj.bias,
                self.norm2.weight, self.norm2.bias,
                self.mlp_fc1.weight.t(), self.mlp_fc1.bias,
                self.mlp_fc2.weight.t(), self.mlp_fc2.bias)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                rng: Optional[DropoutRng] = None) -> torch.Tensor:
        B, D, H, W, C = x.shape
        window, shift = _adjust_window((D, H, W), self.window, self.shift)
        shortcut = x
        h = self.norm1(x)
        pads = ((-D) % window[0], (-H) % window[1], (-W) % window[2])
        h = F.pad(h, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))    # after LN1
        Dp, Hp, Wp = D + pads[0], H + pads[1], W + pads[2]
        mask = None
        if any(shift):
            h = torch.roll(h, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
            mask = compute_shift_mask((Dp, Hp, Wp), window, shift, x.device)
        h = window_reverse(self.attn(window_partition(h, window), mask), window,
                           B, Dp, Hp, Wp)
        if any(shift):
            h = torch.roll(h, shifts=shift, dims=(1, 2, 3))
        x = shortcut + self.drop_path1(h[:, :D, :H, :W], deterministic, rng)
        h = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none"))
        return x + self.drop_path2(h, deterministic, rng)


def fused_block_apply(x: torch.Tensor, blk: SwinBlock3D, full_window: Tuple3,
                      shift: Tuple3, num_heads: int) -> torch.Tensor:
    """One Swin block through ``swin_block_fused`` with the weights of
    ``blk``: pad before the kernel (its ``valid`` mask reproduces the module's
    pad after LN1), roll, partition, kernel, reverse, unroll, slice."""
    B, D, H, W, C = x.shape
    window, shift = _adjust_window((D, H, W), full_window, shift)
    pads = ((-D) % window[0], (-H) % window[1], (-W) % window[2])
    padded = (D + pads[0], H + pads[1], W + pads[2])
    h = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    region = None
    if any(shift):
        h = torch.roll(h, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
        with trace.sync("swin.region"):
            region = torch.from_numpy(_region_partition(padded, window, shift)).to(x.device)
    valid = _valid_partition((D, H, W), padded, window, shift)
    if valid is not None:
        with trace.sync("swin.valid"):
            valid = torch.from_numpy(valid).to(x.device)
    N = window[0] * window[1] * window[2]
    out = swin_block_fused(window_partition(h, window), *blk.kernel_weights(),
                           blk.attn.relative_position_bias(N), num_heads,
                           region=region, valid=valid)
    h = window_reverse(out, window, B, *padded)
    if any(shift):
        h = torch.roll(h, shifts=shift, dims=(1, 2, 3))
    return h[:, :D, :H, :W]


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
    downsample. See the module docstring for the three block routes;
    ``use_kernels`` selects, on the canvas route, ``swin_block_canvas`` (the
    kernel on CUDA, its plain version on the CPU) or the plain version."""

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
        dpr = np.linspace(0.0, c.drop_path_rate, sum(c.depths))
        i = 0
        for stage, depth in enumerate(c.depths):
            dim = c.embed_dim * 2**stage
            for b in range(depth):
                shift = (0, 0, 0) if b % 2 == 0 else tuple(w // 2 for w in c.window)
                setattr(self, f"stage{stage}_block{b}", SwinBlock3D(
                    dim, c.num_heads[stage], c.window, shift, c.mlp_ratio, float(dpr[i])))
                i += 1
            if stage < len(c.depths) - 1:
                setattr(self, f"downsample{stage}", PatchMerging(dim))

    def drop_path_gates(self, rng, batch: int, device) -> Optional[torch.Tensor]:
        """DropPath branch gates [blocks, batch, 2] for one training step:
        keep = 1 - linspace(0, drop_path_rate, blocks), Bernoulli(keep) /
        keep (the JAX package's sampling); None when the rate is 0."""
        c = self.cfg
        if c.drop_path_rate <= 0:
            return None
        total = sum(c.depths)
        keep = torch.from_numpy(1.0 - np.linspace(0.0, c.drop_path_rate, total)).float()
        with trace.sync("swin.drop_path"):
            keep = keep.to(device)[:, None, None].expand(total, batch, 2)
        return rng.bernoulli(keep).float() / keep

    def _canvas_stage(self, x, stage: int, depth: int, gates, blk_base: int):
        """One stage on its window-padded canvas (see the module docstring)."""
        c = self.cfg
        block = swin_block_canvas if self.use_kernels else swin_block_canvas_reference
        _, D_, H_, W_, _ = x.shape
        window, _ = _adjust_window((D_, H_, W_), c.window, (0, 0, 0))
        pads = ((-D_) % window[0], (-H_) % window[1], (-W_) % window[2])
        if any(pads):
            x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
        padded = (D_ + pads[0], H_ + pads[1], W_ + pads[2])
        N = window[0] * window[1] * window[2]
        frame = (0, 0, 0)
        for b in range(depth):
            blk = getattr(self, f"stage{stage}_block{b}")
            _, shift = _adjust_window((D_, H_, W_), c.window, blk.shift)
            rel = tuple((s - f) % p for s, f, p in zip(shift, frame, padded))
            region = valid = None
            if any(shift):
                with trace.sync("swin.region"):
                    region = torch.from_numpy(
                        _region_partition(padded, window, shift)).to(x.device)
            v = _valid_partition((D_, H_, W_), padded, window, shift)
            if v is not None:
                with trace.sync("swin.valid"):
                    valid = torch.from_numpy(v).to(x.device)
            x = block(x, *blk.kernel_weights(), blk.attn.relative_position_bias(N),
                      c.num_heads[stage], window, rel, region=region, valid=valid,
                      gates=None if gates is None else gates[blk_base + b])
            frame = shift
        if any(frame):
            x = torch.roll(x, shifts=frame, dims=(1, 2, 3))
        return x[:, :D_, :H_, :W_]

    def forward(self, frames: torch.Tensor, gates: Optional[torch.Tensor] = None,
                route: str = "canvas", rng: Optional[DropoutRng] = None
                ) -> Dict[str, torch.Tensor]:
        """``route``: "canvas", "module" or "blocks". ``gates`` [blocks, B, 2]
        DropPath branch gates (canvas route, training); ``rng`` the step's
        DropoutRng (module route, training: DropPath active)."""
        if route not in ROUTES:
            raise ValueError(f"route {route!r} is not one of {ROUTES}")
        if gates is not None and route != "canvas":
            raise ValueError("DropPath gates are for the canvas route")
        if rng is not None and route != "module":
            raise ValueError("a DropoutRng is for the module route")
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

        out: Dict[str, torch.Tensor] = {}
        blk_base = 0
        for stage, depth in enumerate(c.depths):
            if route == "canvas":
                x = self._canvas_stage(x, stage, depth, gates, blk_base)
            else:
                for b in range(depth):
                    blk = getattr(self, f"stage{stage}_block{b}")
                    if route == "module":
                        x = blk(x, deterministic=rng is None, rng=rng)
                    else:
                        x = fused_block_apply(x, blk, c.window, blk.shift,
                                              c.num_heads[stage])
            blk_base += depth
            out[str(stage)] = x
            if stage < len(c.depths) - 1:
                x = getattr(self, f"downsample{stage}")(x)
        return out
