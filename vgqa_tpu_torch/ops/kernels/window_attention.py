"""Windowed / per-frame multi-head attention with the heads packed in C.

Replaces ``vgqa_tpu/ops/pallas/window_attention.py:window_attention`` (the
Pallas kernel, body ``_body``). Per row ``w`` of ``[W, N, C]`` q/k/v and per
head ``h``::

    softmax(scale * q_h k_h^T + bias[h] + region mask + key_valid mask) v_h

with the max subtracted in float32. On the serving path the cross-modal
encoder calls it six times per forward with W = V*T = 128 rows, N = S =
2*hw + L tokens (124 at 224 px, 418 at 420 px), C = 256, 8 heads of 32 and
``key_valid`` only; ``bias`` and ``region`` serve the Swin block and tests.

On the H100 the work is O(W*H*N^2*32) multiply-adds against O(W*N*C)
bytes of q/k/v, as long as the [N, N] logits stay out of device memory (a
plain version writes and re-reads them, plus the probabilities, per head).
At the encoder's 420 px call (W 128, N 418) the exponentials bound it:
178.9 M ex2 take 0.0428 ms on the SFUs, above the bytes (0.0328 ms) and
the products (0.023 ms). bf16 takes ``window_attn_sm90_kernel`` in
``csrc/window_attn_sm90.cu``, on K4's Hopper pipeline. A block owns one
(window row, head): one thread starts TMA loads of all of its Q, K and V
(64-row boxes, 64-byte swizzle, rows past N zero-filled) at once, and two
warpgroups take its 64-row query tiles in turn; S = QK^T and P.V are
``wgmma`` (P from registers, V as an MN-major operand), the last key tile
at the smallest width that covers it (n40 at N = 418), the softmax online
in base 2 with the key term folded into one FFMA per logit. With ``bias``
or ``region`` (K1's attention phase, N = 392) the kernel's terms form adds
the bias (TMA boxes of 64 query rows x 64 keys, one key tile ahead of their
use; rows padded here to a multiple of 8 keys; one more FFMA per logit) and
the region compare-and-select.

P is rounded to bf16 as the P.V operand (the TPU kernel does the same);
the row max and sum stay f32.

In float32 (``window_attn_f32_kernel``) nothing is rounded and every
product is an FFMA (single-pass TF32 would not be float32): one thread per
query row, keys and values streamed through shared memory in chunks of 32,
the same online softmax. Bound there by the FFMA rate (67 TFLOP/s on an
H100 SXM against 989 for bf16 on the tensor cores).

``window_attention`` launches the kernel for CUDA tensors and runs
``window_attention_reference`` for CPU tensors; anything else raises. A head
dim below 32 is zero-padded per head to 32 (``padding.pad_heads``) and the
output sliced back, as the Pallas kernel pads to 128; a head dim above 32
or more than ``MAX_TOKENS`` tokens raises on the card.
``python3 chip_k4.py --kernel k2 --other DIR`` times the encoder form
against another checkout (and SDPA) on one card.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import build
from .dtypes import check_kernel_dtype
from .padding import pad_heads, unpad_heads

NEG_INF = -1e30
HEAD_DIM = 32          # the kernel's head dim (every caller on the path)
MAX_TOKENS = 1024      # keys per row the kernel's shared memory holds


def _tile_rows(vec: torch.Tensor, rows: int) -> torch.Tensor:
    if vec.shape[0] != rows:
        if rows % vec.shape[0]:
            raise ValueError(f"{vec.shape[0]} rows do not tile {rows}")
        vec = vec.repeat(rows // vec.shape[0], 1)
    return vec


def window_attention_reference(
    q: torch.Tensor,                           # [W, N, C] heads packed in C
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,       # [H, N, N]
    region: Optional[torch.Tensor] = None,     # [nW, N] int region ids
    key_valid: Optional[torch.Tensor] = None,  # [nW, N] > 0 = attendable key
    num_heads: int = 1,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`window_attention` (same signature):
    f32 logits and softmax, output in the dtype of ``q``."""
    W, N, C = q.shape
    H = num_heads
    D = C // H
    if scale is None:
        scale = D ** -0.5

    def heads(t):
        return t.float().reshape(W, N, H, D).transpose(1, 2)    # [W, H, N, D]

    s = torch.matmul(heads(q), heads(k).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()[None]
    if region is not None:
        r = _tile_rows(region, W)
        s = s + torch.where(r[:, None, :, None] != r[:, None, None, :],
                            NEG_INF, 0.0)
    if key_valid is not None:
        kv = _tile_rows(key_valid, W).float()
        s = s + torch.where(kv[:, None, None, :] > 0, 0.0, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, heads(v))
    return o.transpose(1, 2).reshape(W, N, C).to(q.dtype)


def _device_of(q: torch.Tensor) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"window_attention runs on cpu or cuda, not {q.device}")
    return q.device.type


def launch(q, k, v, out, num_heads: int, scale: float, bias=None,
           region=None, key_valid=None) -> None:
    """Launch K2 on the current stream (no counting): float32 takes
    ``window_attn_f32_kernel``, bf16 ``window_attn_sm90_kernel``.

    q/k/v/out are ``[W, N, >=C]`` views whose last dim is contiguous; heads
    sit at channel offsets h*32 of each token row."""
    W, N = q.shape[0], q.shape[1]
    check_kernel_dtype("window_attention kernel", q.dtype)
    f32 = q.dtype == torch.float32
    for t in (k, v, out):
        if t.dtype != q.dtype or t.device != q.device:
            raise TypeError("q, k, v and out must share dtype and device")
    for t in (q, k, v, out):
        # 16-byte rows: the kernel loads K/V rows as 8-element vectors
        if t.stride(-1) != 1 or t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError("window_attention kernel needs 16-byte aligned, "
                             "channel-contiguous rows")
    if not 1 <= N <= MAX_TOKENS:      # the bf16 kernels' shared memory; the f32 one streams
        raise ValueError(f"window_attention kernel takes 1..{MAX_TOKENS} tokens, not {N}")
    if bias is not None:
        bias = bias.to(q.dtype).contiguous()
        if bias.shape != (num_heads, N, N):
            raise ValueError(f"bias shape {tuple(bias.shape)} != {(num_heads, N, N)}")
        if not f32 and N % 8:           # the bf16 kernel's TMA boxes need 16-byte rows
            bias = F.pad(bias, (0, -N % 8))
    n_region = n_kvalid = 1
    if region is not None:
        region = region.to(device=q.device, dtype=torch.int32).contiguous()
        n_region = region.shape[0]
        if region.shape[1] != N or W % n_region:
            raise ValueError(f"region shape {tuple(region.shape)} does not fit {W}x{N}")
    if key_valid is not None:
        key_valid = key_valid.to(device=q.device, dtype=torch.float32).contiguous()
        n_kvalid = key_valid.shape[0]
        if key_valid.shape[1] != N or W % n_kvalid:
            raise ValueError(f"key_valid shape {tuple(key_valid.shape)} does not fit {W}x{N}")
    lib = build.load_library()
    strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1),
               v.stride(0), v.stride(1), out.stride(0), out.stride(1))
    if f32:
        err = lib.vgqa_window_attention_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), W, N, num_heads,
            *strides, build.ptr(bias), build.ptr(region), n_region,
            build.ptr(key_valid), n_kvalid, float(scale), build.stream_handle(q.device))
    else:
        err = lib.vgqa_window_attention_sm90(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), W, N, num_heads,
            *strides, build.ptr(key_valid), n_kvalid, build.ptr(bias),
            0 if bias is None else bias.shape[-1], build.ptr(region), n_region,
            float(scale), build.stream_handle(q.device))
    build.check(err, "window_attention")


def window_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    region: Optional[torch.Tensor] = None,
    key_valid: Optional[torch.Tensor] = None,
    num_heads: int = 1,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Multi-head window attention; see the module docstring.

    ``region``/``key_valid`` may cover fewer rows than ``q`` when the pattern
    repeats across a leading batch (row w reads row ``w % rows``)."""
    W, N, C = q.shape
    if C % num_heads:
        raise ValueError(f"{C} channels do not split into {num_heads} heads")
    dh = C // num_heads
    if scale is None:
        scale = dh ** -0.5
    if _device_of(q) == "cpu":
        return window_attention_reference(q, k, v, bias, region, key_valid,
                                          num_heads, scale)
    if dh > HEAD_DIM:
        raise ValueError(f"window_attention kernel takes head dims up to {HEAD_DIM} "
                         f"(padded), not {dh}")
    q, k, v = (pad_heads(t, num_heads, HEAD_DIM) for t in (q, k, v))
    out = torch.empty((W, N, num_heads * HEAD_DIM), dtype=q.dtype, device=q.device)
    launch(q, k, v, out, num_heads, scale, bias, region, key_valid)
    window_attention.launches += 1
    return unpad_heads(out, num_heads, dh)


window_attention.launches = 0
