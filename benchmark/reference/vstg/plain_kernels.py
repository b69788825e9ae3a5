"""Plain PyTorch versions of every kernel the grounding model calls, for the
reference copy of the model in this folder.

The model modules beside this file are frozen copies of the port's model
code; where the port calls a hand-written kernel (the Swin block chain, the
window attention, the training attention with in-kernel dropout), the copy
calls the function of the same name here, which computes the same function
with plain torch operations in float32. The dropout keep mask of the
training attention is the port's published definition (word j mod 4 of
Philox4x32-10 with key (seed + row, 0) and counter (i, j // 4, 0, 0), kept
when its top 24 bits reach ceil(rate * 2^24)), written again here in torch
integer operations, so that the reference draws the masks the port draws.

Data parallelism is not part of the reference: ``get_world_size`` is 1 and
``all_reduce_`` is the identity.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30
LN_EPS = 1e-5
MAX_SEQ_PAD = 1024
_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def get_world_size() -> int:
    return 1


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    return t


# -- window attention (the encoder's eval attention and the Swin block's) ------
def _tile_rows(vec: torch.Tensor, rows: int) -> torch.Tensor:
    if vec.shape[0] != rows:
        vec = vec.repeat(rows // vec.shape[0], 1)
    return vec


def window_attention(q, k, v, bias=None, region=None, key_valid=None, num_heads: int = 1,
                     scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v [W, N, C] heads packed in C; f32 logits and softmax."""
    W, N, C = q.shape
    H = num_heads
    D = C // H
    if scale is None:
        scale = D ** -0.5

    def heads(t):
        return t.float().reshape(W, -1, H, D).transpose(1, 2)

    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()[None]
    if region is not None:
        r = _tile_rows(region, W)
        s = s + torch.where(r[:, None, :, None] != r[:, None, None, :], NEG_INF, 0.0)
    if key_valid is not None:
        kv = _tile_rows(key_valid, W).float()
        s = s + torch.where(kv[:, None, None, :] > 0, 0.0, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, heads(v))
    return o.transpose(1, 2).reshape(W, N, C).to(q.dtype)


# -- training attention with dropout -------------------------------------------
def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def supported_seq(Lq: int, Lk: int) -> bool:
    return _round_up(Lq, 128) <= MAX_SEQ_PAD and _round_up(Lk, 128) <= MAX_SEQ_PAD


def keep_threshold(rate: float) -> int:
    return min(1 << 24, max(0, math.ceil(float(np.float32(rate)) * (1 << 24))))


def _mulhilo(a: torch.Tensor, m: int):
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    mid = a_hi * m_lo + a_lo * m_hi
    t = a_lo * m_lo + ((mid & 0xFFFF) << 16)
    return (a_hi * m_hi + (mid >> 16) + (t >> 32)) & _MASK32, t & _MASK32


def philox4x32(counter, key):
    """Philox4x32-10 (Random123) on int64 tensors holding uint32 values."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W0) & _MASK32, (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.broadcast_tensors(c0, c1, c2, c3)


def keep_mask(seed: int, rows: int, Lq: int, Lk: int, rate: float, device=None):
    """[rows, Lq, Lk] bool, True = keep."""
    thresh = keep_threshold(rate)
    out = torch.empty((rows, Lq, Lk), dtype=torch.bool, device=device)
    groups = (Lk + 3) // 4
    i = torch.arange(Lq, dtype=torch.int64, device=device)[None, :, None]
    c = torch.arange(groups, dtype=torch.int64, device=device)[None, None, :]
    chunk = max(1, (1 << 22) // (Lq * groups))
    for r in range(0, rows, chunk):
        n = min(chunk, rows - r)
        key = ((int(seed) + r + torch.arange(n, dtype=torch.int64, device=device))
               & _MASK32)[:, None, None]
        words = torch.stack(philox4x32((i, c, 0, 0), (key, 0)), dim=-1)
        out[r:r + n] = ((words >> 8) >= thresh).reshape(n, Lq, 4 * groups)[..., :Lk]
    return out


def flash_mha_train(q, k, v, num_heads: int, key_mask=None, dropout_rate: float = 0.0,
                    seed: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """Attention with probability dropout, differentiated by autograd:
    q [..., Lq, H*dh], k/v [..., Lk, H*dh]; folded row b = (lead, head)
    keeps key j of query i by keep(seed + b, i, j)."""
    *lead, Lq, dim = q.shape
    Lk = k.shape[-2]
    H = num_heads
    dh = dim // H
    if scale is None:
        scale = dh ** -0.5
    W = int(np.prod(lead)) if lead else 1

    def fold(t, L):
        return t.reshape(W, L, H, dh).transpose(1, 2).reshape(W * H, L, dh).float()

    s = torch.matmul(fold(q, Lq), fold(k, Lk).transpose(1, 2)) * scale
    if key_mask is not None:
        m = key_mask.to(torch.bool).expand(*lead, Lk).reshape(W, 1, 1, Lk)
        s = torch.where(m.expand(W, H, 1, Lk).reshape(W * H, 1, Lk), s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    if dropout_rate > 0.0:
        keep = keep_mask(seed, W * H, Lq, Lk, dropout_rate, q.device)
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - dropout_rate))
    o = torch.matmul(p, fold(v, Lk))
    return o.reshape(W, H, Lq, dh).transpose(1, 2).reshape(*lead, Lq, dim).to(q.dtype)


# -- the Swin block -------------------------------------------------------------
def _partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    B, D, H, W = x.shape[:4]
    wd, wh, ww = window
    rest = x.shape[4:]
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, *rest)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, *range(7, 7 + len(rest)))
    return x.reshape(-1, wd * wh * ww, *rest)


def _reverse(win: torch.Tensor, window: Sequence[int], B, D, H, W) -> torch.Tensor:
    wd, wh, ww = window
    x = win.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, -1)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, -1)


def _block_on_windows(xx, ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj, ln2_scale,
                      ln2_bias, wfc1, bfc1, wfc2, bfc2, bias, num_heads, region, valid,
                      gates) -> torch.Tensor:
    """One Swin block on windows [W, N, C]: LN1, qkv, windowed attention
    with the relative-position bias and the shift regions, proj, DropPath
    gate, residual, LN2, MLP with erf GELU, gate, residual. Weights in the
    [in, out] layout."""
    W, N, C = xx.shape
    dt = xx.dtype
    h = F.layer_norm(xx.float(), (C,), ln1_scale.float(), ln1_bias.float(), LN_EPS)
    if valid is not None:
        h = h * _tile_rows(valid, W).float()[..., None]
    h = h.to(dt)
    qkv = (torch.matmul(h.float(), wqkv.float()) + bqkv.float()).to(dt)
    attn = window_attention(qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], bias,
                            region, None, num_heads)
    proj = (torch.matmul(attn.float(), wproj.float()) + bproj.float()).to(dt)
    if gates is not None:
        proj = proj * gates[:, 0, None, None].to(dt)
    x1 = xx + proj
    h2 = F.layer_norm(x1.float(), (C,), ln2_scale.float(), ln2_bias.float(), LN_EPS).to(dt)
    f = F.gelu(torch.matmul(h2.float(), wfc1.float()) + bfc1.float(), approximate="none")
    f = (torch.matmul(f, wfc2.float()) + bfc2.float()).to(dt)
    if gates is not None:
        f = f * gates[:, 1, None, None].to(dt)
    return x1 + f


def swin_block_canvas(canvas, ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj, ln2_scale,
                      ln2_bias, wfc1, bfc1, wfc2, bfc2, bias, num_heads, window, roll,
                      region=None, valid=None, gates=None) -> torch.Tensor:
    """One block on a window-padded canvas [B, Dp, Hp, Wp, C], read rolled
    by ``-roll``; ``gates`` [B, 2] DropPath gates."""
    B, Dp, Hp, Wp, C = canvas.shape
    nW = (Dp // window[0]) * (Hp // window[1]) * (Wp // window[2])
    rd, rh, rw = (int(r) % s for r, s in zip(roll, (Dp, Hp, Wp)))
    x = torch.roll(canvas, shifts=(-rd, -rh, -rw), dims=(1, 2, 3))
    g = None if gates is None else gates.float().repeat_interleave(nW, dim=0)
    out = _block_on_windows(_partition(x, window), ln1_scale, ln1_bias, wqkv, bqkv, wproj,
                            bproj, ln2_scale, ln2_bias, wfc1, bfc1, wfc2, bfc2, bias,
                            num_heads, region, valid, g)
    return _reverse(out, window, B, Dp, Hp, Wp)


swin_block_canvas_reference = swin_block_canvas


def swin_block_fused(x, ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj, ln2_scale, ln2_bias,
                     wfc1, bfc1, wfc2, bfc2, bias, num_heads, region=None,
                     valid=None) -> torch.Tensor:
    return _block_on_windows(x, ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj, ln2_scale,
                             ln2_bias, wfc1, bfc1, wfc2, bfc2, bias, num_heads, region,
                             valid, None)
