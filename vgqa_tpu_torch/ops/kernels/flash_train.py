"""Differentiable attention with probability dropout, for training (K3).

Replaces ``vgqa_tpu/ops/pallas/flash_train.py:flash_mha_train`` (the custom
VJP over the Pallas ``_fwd_kernel`` and ``_bwd_kernel``). Per folded row
b = (lead index, head) of q/k/v ``[..., L, H*dh]``::

    S = q k^T * scale, keys with mask False -> -1e30
    lse = m + log(l)                     (m = row max, l = sum exp(S - m))
    O = (keep * exp(S - m) / (1 - rate)) v / max(l, 1e-30)

and the backward recomputes P = exp(S - lse) from (q, k, lse), takes the
forward's keep mask, and gives dq, dk, dv with delta = rowsum(dO * O) (O as
stored in the input dtype), dS = P (dP - delta) scale.

The dropout keep mask is a pure function keep(seed + b, i, j): word
(j mod 4) of Philox4x32-10 with key (seed + b, 0) and counter
(i, floor(j / 4), 0, 0), kept when its top 24 bits are >=
ceil(f32(rate) * 2^24) (the threshold of the Pallas ``_keep_mask``). One
call gives the decisions of four neighbouring keys. The TPU's hardware bits
cannot be reproduced; this definition is written once in CUDA and once in
torch integer ops (:func:`keep_mask`), so the kernel and the plain version
draw bit-identical masks.

On the H100 the forward is ``attn_fwd_kernel<32, MODE_K3>`` in
``csrc/flash_attention.cu`` (K4/K5's kernel: keys and values in blocks of 64
through ``cp.async`` double buffers, V's fragments through
``ldmatrix.trans``, ``mma.sync`` m16n8k16 with f32 accumulation, the logits
in base 2 so that each probability is one ``ex2``). Each lane draws one
Philox call per group of four keys and swaps keep bits with its quad
partner, and the forward writes the decisions as bits
(:func:`pack_keep_bits`'s layout, ``[W*H, Lq, ceil(Lk/32)]`` int32, 12 MB at
[512, 418]), which :class:`_FlashTrain` saves beside lse: the mask is drawn
once per call. The CPU path keeps the same flow: its forward returns the
mask it drew as bits and its backward unpacks them. The backward (``csrc/flash_train.cu``) is one launch: a
block per key tile of one (w, h) keeps dk and dv in registers and walks the
query blocks once, recomputing S and dP once; dq = dS K goes into a per-tile
f32 partial in shared memory, and the key tiles of a (w, h) form a
thread-block cluster that computes delta and then sums the dq partials in a
fixed order through distributed shared memory. No atomics: the results are
bit-equal between runs. The port pads nothing (Pallas pads L and dh to 128):
the kernels mask the ragged edge.

What bounds K3 on this card at the training path's shapes (512 rows = 64
frames x 8 heads, L = 124 or 418, dh = 32): the bytes (q, k, v and the
output forward; q, k, v, O, dO, lse and the three gradients back: 17 + 33 us
at L = 418), and beside them the exponentials: one pass of B L^2 = 89.5 M at
L = 418 takes ~21 us on the SFUs (16 per SM per clock), more than the
tensor-core work (~12 us forward) of a 32-deep head.

In float32 (``TPU.TRAIN_DTYPE float32``, the default) the forward and the
backward are their float32 forms (``train_fwd_f32_kernel`` in
``csrc/flash_attention.cu``, ``flash_bwd_f32_kernel`` in
``csrc/flash_train.cu``): FFMA products and nothing rounded, as the Pallas
kernels at f32. The forward draws the keep bits with the same Philox calls,
so bf16 and f32 calls with the same seed and shape keep the same elements.
The f32 backward is one launch whose blocks own either a key (dk, dv) or a
query (dq) of a folded row: no atomics, one writer per output element.

``flash_mha_train`` launches the kernels for CUDA tensors (bf16 or f32)
and runs the plain version for CPU tensors; anything else raises.
``flash_mha_train.fwd_launches`` / ``.bwd_launches`` count the launches.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import build
from .dtypes import check_kernel_dtype

NEG_INF = -1e30
MAX_SEQ_PAD = 1024       # the Pallas kernel's full-S block limit
HEAD_DIM = 32            # the kernels' head dim (every caller on the path)
_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def supported_seq(Lq: int, Lk: int) -> bool:
    """The JAX route's rule (full-S Pallas block fits scoped VMEM); the port
    keeps it so both packages route the same calls to the kernel."""
    return _round_up(Lq, 128) <= MAX_SEQ_PAD and _round_up(Lk, 128) <= MAX_SEQ_PAD


def keep_threshold(rate: float) -> int:
    """Integer threshold on the top 24 bits: ``(bits >> 8) >= t`` equals the
    Pallas test ``(bits >> 8) * 2^-24 >= rate`` with rate in float32."""
    return min(1 << 24, max(0, math.ceil(float(np.float32(rate)) * (1 << 24))))


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit halves of a * m for int64 tensors holding uint32
    values, in 16-bit pieces so that nothing overflows int64."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    m_lo, m_hi = m & 0xFFFF, m >> 16
    mid = a_hi * m_lo + a_lo * m_hi
    t = a_lo * m_lo + ((mid & 0xFFFF) << 16)
    return (a_hi * m_hi + (mid >> 16) + (t >> 32)) & _MASK32, t & _MASK32


def philox4x32(counter, key):
    """Philox4x32-10 (Random123): the four output words for ``counter``
    (c0, c1, c2, c3) and ``key`` (k0, k1), each an int64 tensor (or int)
    holding uint32 values, broadcast together."""
    c0, c1, c2, c3 = (torch.as_tensor(c, dtype=torch.int64) for c in counter)
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) for k in key)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W0) & _MASK32, (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, _PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return torch.broadcast_tensors(c0, c1, c2, c3)


def keep_mask(seed: int, rows: int, Lq: int, Lk: int, rate: float,
              device=None) -> torch.Tensor:
    """The kernels' keep mask [rows, Lq, Lk] (True = keep) for folded rows
    0..rows-1: key j of (row b, query i) is word j % 4 of the Philox call
    with counter (i, j // 4), drawn with torch integer ops in chunks of rows."""
    thresh = keep_threshold(rate)
    out = torch.empty((rows, Lq, Lk), dtype=torch.bool, device=device)
    groups = (Lk + 3) // 4
    i = torch.arange(Lq, dtype=torch.int64, device=device)[None, :, None]
    c = torch.arange(groups, dtype=torch.int64, device=device)[None, None, :]
    chunk = max(1, (1 << 20) // (Lq * groups))
    for r in range(0, rows, chunk):
        n = min(chunk, rows - r)
        key = ((int(seed) + r + torch.arange(n, dtype=torch.int64, device=device))
               & _MASK32)[:, None, None]
        words = torch.stack(philox4x32((i, c, 0, 0), (key, 0)), dim=-1)   # [n, Lq, G, 4]
        out[r:r + n] = ((words >> 8) >= thresh).reshape(n, Lq, 4 * groups)[..., :Lk]
    return out


def pack_keep_bits(keep: torch.Tensor) -> torch.Tensor:
    """[rows, Lq, Lk] bool -> [rows, Lq, ceil(Lk/32)] int32 (uint32 bit
    patterns): bit j % 32 of word j // 32 is key j, zero past Lk; the layout
    of the bits the forward kernel writes."""
    rows, Lq, Lk = keep.shape
    nw = (Lk + 31) // 32
    padded = torch.zeros((rows, Lq, nw * 32), dtype=torch.int64, device=keep.device)
    padded[..., :Lk] = keep.to(torch.int64)
    weights = torch.tensor([1 << b for b in range(32)], dtype=torch.int64, device=keep.device)
    words = (padded.reshape(rows, Lq, nw, 32) * weights).sum(-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def unpack_keep_bits(bits: torch.Tensor, Lk: int) -> torch.Tensor:
    """Inverse of :func:`pack_keep_bits`: [rows, Lq, nw] int32 -> [rows, Lq, Lk] bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    keep = (bits[..., None] >> shifts) & 1
    return keep.reshape(*bits.shape[:-1], -1)[..., :Lk].to(torch.bool)


def _fwd_plain(q, k, v, key_mask, keep, rate: float, scale: float):
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if key_mask is not None:
        s = torch.where(key_mask[:, None, :], s, NEG_INF)
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    lse = m + torch.log(l)
    if keep is not None:
        p = torch.where(keep, p, 0.0) * (1.0 / (1.0 - rate))
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype), lse


def _bwd_plain(q, k, v, o, do, lse, key_mask, keep, rate: float, scale: float):
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if key_mask is not None:
        s = torch.where(key_mask[:, None, :], s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dp = torch.matmul(do.float(), v.float().transpose(1, 2))
    pw = p
    if keep is not None:
        inv = 1.0 / (1.0 - rate)
        dp = torch.where(keep, dp, 0.0) * inv
        pw = torch.where(keep, p, 0.0) * inv
    delta = (do.float() * o.float()).sum(-1)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
    dv = torch.matmul(pw.to(do.dtype).float().transpose(1, 2), do.float()).to(v.dtype)
    dq = torch.matmul(ds.float(), k.float()).to(q.dtype)
    dk = torch.matmul(ds.float().transpose(1, 2), q.float()).to(k.dtype)
    return dq, dk, dv


def _keep_or_none(seed: int, q, k, rate: float):
    if rate <= 0.0:
        return None
    return keep_mask(seed, q.shape[0], q.shape[1], k.shape[1], rate, q.device)


def flash_train_fwd_reference(q, k, v, key_mask, seed: int, rate: float,
                              scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward on folded rows (the math of the Pallas ``_fwd_kernel``):
    q [B, Lq, dh], k/v [B, Lk, dh], key_mask [B, Lk] bool or None.
    Returns (out [B, Lq, dh] in q's dtype, lse [B, Lq] f32)."""
    return _fwd_plain(q, k, v, key_mask, _keep_or_none(seed, q, k, rate), rate, scale)


def flash_train_bwd_reference(q, k, v, o, do, lse, key_mask, seed: int, rate: float,
                              scale: float):
    """Plain backward on folded rows (the math of the Pallas ``_bwd_kernel``).
    Returns (dq, dk, dv) in the input dtypes."""
    return _bwd_plain(q, k, v, o, do, lse, key_mask, _keep_or_none(seed, q, k, rate), rate,
                      scale)


def fold_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[W, L, H*dh] -> [W*H, L, dh] (row w*H + h), the JAX wrapper's fold."""
    W, L, C = x.shape
    return x.reshape(W, L, heads, C // heads).transpose(1, 2).reshape(W * heads, L, C // heads)


def unfold_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[W*H, L, dh] -> [W, L, H*dh]"""
    B, L, dh = x.shape
    return x.reshape(B // heads, heads, L, dh).transpose(1, 2).reshape(B // heads, L, heads * dh)


def _check_cuda(q, k, v, mask, heads: int) -> None:
    check_kernel_dtype("flash_mha_train kernel", q.dtype)
    for t in (k, v):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError("q, k and v must share dtype and device")
    if q.shape[-1] != heads * HEAD_DIM or k.shape[-1] != q.shape[-1] or v.shape != k.shape:
        raise ValueError(f"flash_mha_train kernel takes head dim {HEAD_DIM}: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"{heads} heads")
    if mask is not None and tuple(mask.shape) != (q.shape[0], k.shape[1]):
        raise ValueError(f"key mask {tuple(mask.shape)} != {(q.shape[0], k.shape[1])}")


def _kernel_args(mask, seed: int, rate: float):
    mask_u8 = None if mask is None else mask.to(torch.uint8).contiguous()
    seed32 = int(np.int64(seed).astype(np.int32))
    return (mask_u8, seed32, keep_threshold(rate), int(rate > 0.0),
            float(np.float32(1.0 / (1.0 - rate))))


def _device_of(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"flash_mha_train runs on cpu or cuda, not {q.device}")
    return q.device.type


def flash_train_fwd(q, k, v, mask, seed: int, rate: float, scale: float, heads: int):
    """Forward with heads packed: q [W, Lq, H*dh], k/v [W, Lk, H*dh], mask
    [W, Lk] bool or None -> (out [W, Lq, H*dh], lse [W*H, Lq] f32, keep bits
    [W*H, Lq, ceil(Lk/32)] int32, None at rate 0). Launches the kernel for
    CUDA tensors, runs the plain version for CPU tensors; both return the
    keep mask they drew as bits, for :func:`flash_train_bwd`."""
    if _device_of(q) == "cpu":
        maskf = None if mask is None else mask.repeat_interleave(heads, dim=0)
        qf, kf = fold_heads(q, heads), fold_heads(k, heads)
        keep = _keep_or_none(seed, qf, kf, rate)
        o, lse = _fwd_plain(qf, kf, fold_heads(v, heads), maskf, keep, rate, scale)
        return unfold_heads(o, heads), lse, None if keep is None else pack_keep_bits(keep)
    _check_cuda(q, k, v, mask, heads)
    W, Lq, _ = q.shape
    Lk = k.shape[1]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o = torch.empty_like(q)
    lse = torch.empty((W * heads, Lq), dtype=torch.float32, device=q.device)
    mask_u8, seed32, thresh, drop, inv = _kernel_args(mask, seed, rate)
    bits = None
    if drop:
        bits = torch.empty((W * heads, Lq, (Lk + 31) // 32), dtype=torch.int32, device=q.device)
    lib = build.load_library()
    entry = lib.vgqa_flash_train_fwd_f32 if q.dtype == torch.float32 else lib.vgqa_flash_train_fwd
    build.check(entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        build.ptr(bits), build.ptr(mask_u8), W, Lq, Lk, heads, float(scale), seed32,
        thresh, drop, inv, build.stream_handle(q.device)), "flash_mha_train forward")
    flash_mha_train.fwd_launches += 1
    return o, lse, bits


def flash_train_bwd(q, k, v, o, do, lse, keep_bits, mask, rate: float, scale: float,
                    heads: int):
    """Backward of :func:`flash_train_fwd` -> (dq, dk, dv) in the packed
    layout and the input dtypes. ``keep_bits`` is the forward's (None at
    rate 0); the kernel and the plain version both read it and draw nothing."""
    do = do.to(q.dtype)
    W, Lq, _ = q.shape
    Lk = k.shape[1]
    if (rate > 0.0) != (keep_bits is not None) or (keep_bits is not None and (
            tuple(keep_bits.shape) != (W * heads, Lq, (Lk + 31) // 32)
            or keep_bits.dtype != torch.int32)):
        raise ValueError("flash_mha_train backward takes the forward's keep bits "
                         f"[{W * heads}, {Lq}, {(Lk + 31) // 32}] int32 at rate > 0, "
                         "None at rate 0")
    if _device_of(q) == "cpu":
        maskf = None if mask is None else mask.repeat_interleave(heads, dim=0)
        keep = None if keep_bits is None else unpack_keep_bits(keep_bits, Lk)
        grads = _bwd_plain(
            fold_heads(q, heads), fold_heads(k, heads), fold_heads(v, heads),
            fold_heads(o, heads), fold_heads(do, heads), lse, maskf, keep, rate, scale)
        return tuple(unfold_heads(g, heads) for g in grads)
    _check_cuda(q, k, v, mask, heads)
    q, k, v, o, do = (t.contiguous() for t in (q, k, v, o, do))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    mask_u8, _, _, drop, inv = _kernel_args(mask, 0, rate)
    bits = keep_bits.contiguous() if drop else None
    lib = build.load_library()
    entry = lib.vgqa_flash_train_bwd_f32 if q.dtype == torch.float32 else lib.vgqa_flash_train_bwd
    build.check(entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.contiguous().data_ptr(), build.ptr(bits), build.ptr(mask_u8), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), W, Lq, Lk, heads, float(scale), drop, inv,
        build.stream_handle(q.device)), "flash_mha_train backward")
    flash_mha_train.bwd_launches += 1
    return dq, dk, dv


class _FlashTrain(torch.autograd.Function):
    """Heads packed: q [W, Lq, H*dh], k/v [W, Lk, H*dh], mask [W, Lk]."""

    @staticmethod
    def forward(ctx, q, k, v, mask, seed, rate, scale, heads):
        o, lse, bits = flash_train_fwd(q, k, v, mask, seed, rate, scale, heads)
        ctx.save_for_backward(q, k, v, o, lse, mask, bits)
        ctx.args = (rate, scale, heads)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, mask, bits = ctx.saved_tensors
        dq, dk, dv = flash_train_bwd(q, k, v, o, do, lse, bits, mask, *ctx.args)
        return dq, dk, dv, None, None, None, None, None


def flash_mha_train(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    seed: int = 0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Differentiable attention with probability dropout (the JAX signature
    and layout): q [..., Lq, H*dh], k/v [..., Lk, H*dh], key_mask [..., Lk]
    True = attend; ``seed`` an int (int32 range) drawn per call site and
    step. Heads fold into the batch; folded row b draws keep(seed + b, i, j)."""
    *lead, Lq, dim = q.shape
    Lk = k.shape[-2]
    dh = dim // num_heads
    if dim % num_heads:
        raise ValueError(f"{dim} channels do not split into {num_heads} heads")
    if scale is None:
        scale = dh ** -0.5
    W = int(np.prod(lead)) if lead else 1
    mask = None
    if key_mask is not None:
        mask = key_mask.to(torch.bool).expand(*lead, Lk).reshape(W, Lk)
    out = _FlashTrain.apply(q.reshape(W, Lq, dim), k.reshape(W, Lk, dim),
                            v.reshape(W, Lk, dim), mask, int(seed), float(dropout_rate),
                            float(scale), num_heads)
    return out.reshape(*lead, Lq, dim)


flash_mha_train.fwd_launches = 0
flash_mha_train.bwd_launches = 0
