"""Serving attention: non-causal multi-head (K4) and causal grouped-query
prefill (K5).

K4 ``flash_mha`` replaces ``vgqa_tpu/ops/pallas/flash_attention.py:
flash_attention`` / ``flash_mha`` (Pallas ``_flash_kernel``): per folded row
(lead index, head) of q/k/v ``[..., L, H*dh]``::

    S = q k^T * scale, keys with key_mask False -> -1e30
    O = exp(S - m) v / max(l, 1e-30)          (m row max, l row sum)

with P = exp(S - m) rounded to the input dtype before the value product.
Its caller is the InternViT attention (``qa/vit.py``): 24 layers x one call
per vision chunk at q/k/v ``[8 tiles, 1025, 16*64]`` bf16.

K5 ``flash_gqa_causal`` replaces ``flash_attention.py:flash_gqa_causal``
(Pallas ``_flash_gqa_causal_kernel``): query head h of ``q [H, Lq, dh]``
(positions q_offset .. q_offset + Lq - 1) reads KV head h // (H // Hkv) of
the cache ``[Hkv, S, dh]``; key j is masked (-1e30) where
``j > q_offset + i`` or ``j >= length``. Its caller is every LLM prefill
(``qa/llm.py``): 32 layers x 9 chunks of Lq = 1024 at S = 9216, dh = 128,
H = 32, Hkv = 8 per 32-frame request.

On the H100 K4 at the ViT shape is 2*2*1025^2*64 FLOP per (tile, head),
34.4 GFLOP per 8-tile call (0.035 ms of dense bf16) with 134.5 M
exponentials (~0.032 ms on the SFUs) against 17 MB of q/k/v/out, and K5 is
causal prefill attention at up to ~144 GFLOP per chunk (22.4 ms of dense
bf16 per 32-frame prefill; 43.4 G exponentials, 10.4 ms) against ~40 MB:
both are bound by the arithmetic, provided the logits and probabilities
stay out of device memory (a plain version writes and re-reads [Lq, Lk]
f32 per head: 1.2 GB per K5 call).

Both run Hopper kernels on one pipeline (the device helpers of
``csrc/sm90_common.cuh``): a producer warp streams K/V tiles of 128 keys by
TMA into a 3-stage ``mbarrier`` ring (128-byte swizzle; 3-D tensor maps
over the strided views, so the qkv slices, the transposed q of the LLM and
the caches are read in place, and rows past the end are zero-filled);
consumer warpgroups of 64 query rows issue S = Q K^T and O += P V as
``wgmma`` (P from registers, V as an MN-major operand), keep S of the next
tile and P V of the last in flight together, take turns to issue them, and
run the softmax online in base 2 (one ``ex2.approx`` per logit).

K4 (``csrc/flash_mha_sm90.cu``): three consumer warpgroups (192 query rows
of one (row, head) per block), a maskless and a masked variant (a per-key
term in shared memory) compiled apart.

K5 (``csrc/flash_gqa_sm90.cu``): two consumer warpgroups (D = 128 leaves
room for no third) own 2 x 64 / G query positions of all G = H / Hkv query
heads of one KV head, so each K/V tile feeds 128 rows of one causal
frontier; tiles wholly below the block's first position and below
``length`` take no compare, only the diagonal and ``length`` tiles mask,
tiles past both are never loaded, and the heaviest query tiles start
first. ``length`` is read from device memory (no host sync per prefill).
G must be a power of two up to 64 (InternLM2.5: 4).

A K4 row whose keys are all masked averages V over its Lk keys (every logit
is -1e30). The Pallas kernel also counts the zero rows it pads keys with up
to a multiple of its block, so its value for such a row depends on the
block size; the port's does not. The InternViT never masks.

Both wrappers launch the kernel for CUDA tensors (bf16; head dim 64 for K4,
128 for K5, the dims of the QA path) and run the plain version for CPU
tensors; another device raises. A smaller head dim is zero-padded per head
up to the kernel's (``padding``) with the scale of the true head dim, and
the output sliced back, as the Pallas kernels pad to 128. A larger head
dim, a dtype other than bf16 (the float32 engine of ``__tiny__``), or a K5
group that is not a power of two up to 64 raises on the card. ``python3
chip_k4.py --kernel k5 --other DIR`` times K5 (``--kernel k4``: K4) against another checkout on one card.
``flash_mha.launches`` / ``flash_gqa_causal.launches`` count the launches.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from . import build
from .padding import pad_heads, pad_last, unpad_heads

NEG_INF = -1e30
K4_HEAD_DIM = 64           # InternViT
K5_HEAD_DIM = 128          # InternLM2.5


def _device_of(q: torch.Tensor, what: str) -> str:
    if q.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what} runs on cpu or cuda, not {q.device}")
    return q.device.type


def _check_rows(what: str, *ts: torch.Tensor) -> None:
    """The kernel loads 8 bf16 at a time: 16-byte aligned, channel-contiguous rows."""
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what} kernel takes bfloat16, not {t.dtype}")
        if t.device != ts[0].device:
            raise TypeError(f"{what}: operands on {t.device} and {ts[0].device}")
        if (t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1])
                or t.data_ptr() % 16):
            raise ValueError(f"{what} kernel needs 16-byte aligned, channel-contiguous "
                             f"rows (strides {t.stride()})")


def flash_mha_reference(q, k, v, num_heads: int, key_mask=None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`flash_mha` (same signature): f32 logits and
    softmax statistics, P in the input dtype for the value product."""
    *lead, Lq, dim = q.shape
    Lk = k.shape[-2]
    dh = dim // num_heads
    if scale is None:
        scale = dh ** -0.5

    def heads(t, L):
        return t.reshape(-1, L, num_heads, dh).transpose(1, 2)       # [B, H, L, dh]

    s = torch.matmul(heads(q, Lq).float(), heads(k, Lk).float().transpose(-1, -2)) * scale
    if key_mask is not None:
        m = key_mask.to(torch.bool).expand(*lead, Lk).reshape(-1, 1, 1, Lk)
        s = torch.where(m, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), heads(v, Lk).float()) / l.clamp_min(1e-30)
    return o.transpose(1, 2).reshape(*lead, Lq, dim).to(q.dtype)


def flash_mha_operands(q, k, v, num_heads: int, key_mask=None):
    """The K4 kernel's operands, checked: ``[B, L, C]`` views of q/k/v (a
    reshape of a row-strided slice keeps its strides), the ``[B, Lq, C]``
    output and the uint8 key mask ``[B, Lk]`` or None. Raises for a head dim
    other than 64, mismatched shapes, a dtype other than bf16, and rows the
    tensor maps cannot address (channel stride 1, other strides multiples
    of 8 elements, 16-byte aligned)."""
    *lead, Lq, dim = q.shape
    Lk = k.shape[-2]
    dh = dim // num_heads
    if dim % num_heads or dh != K4_HEAD_DIM:
        raise ValueError(f"flash_mha kernel takes head dim {K4_HEAD_DIM}, not "
                         f"{dim} / {num_heads}")
    if k.shape[-1] != dim or v.shape != k.shape or tuple(k.shape[:-2]) != tuple(lead):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    B = 1
    for s in lead:
        B *= s
    q3, k3, v3 = q.reshape(B, Lq, dim), k.reshape(B, Lk, dim), v.reshape(B, Lk, dim)
    out = torch.empty((B, Lq, dim), dtype=q.dtype, device=q.device)
    _check_rows("flash_mha", q3, k3, v3, out)
    mask = None
    if key_mask is not None:
        mask = key_mask.to(torch.bool).expand(*lead, Lk).reshape(B, Lk).to(torch.uint8)
        mask = mask.contiguous().to(q.device)
    return q3, k3, v3, out, mask


def flash_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    num_heads: int,
    key_mask: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention with the heads packed in the channel dim (the JAX signature
    and layout): q [..., Lq, H*dh], k/v [..., Lk, H*dh], key_mask [..., Lk]
    True = attend. Returns [..., Lq, H*dh] in q's dtype."""
    *lead, Lq, dim = q.shape
    Lk = k.shape[-2]
    if dim % num_heads:
        raise ValueError(f"{dim} channels do not split into {num_heads} heads")
    dh = dim // num_heads
    if scale is None:
        scale = dh ** -0.5
    if _device_of(q, "flash_mha") == "cpu":
        return flash_mha_reference(q, k, v, num_heads, key_mask, scale)
    if dh > K4_HEAD_DIM:
        raise ValueError(f"flash_mha kernel takes head dims up to {K4_HEAD_DIM} (padded), "
                         f"not {dh}")
    q, k, v = (pad_heads(t, num_heads, K4_HEAD_DIM) for t in (q, k, v))
    q3, k3, v3, out, mask = flash_mha_operands(q, k, v, num_heads, key_mask)
    B, dp = q3.shape[0], K4_HEAD_DIM
    build.check(build.load_library().vgqa_flash_mha(
        q3.data_ptr(), k3.data_ptr(), v3.data_ptr(), out.data_ptr(), build.ptr(mask),
        B, Lq, Lk, num_heads, dp, q3.stride(0), q3.stride(1), k3.stride(0), k3.stride(1),
        v3.stride(0), v3.stride(1), out.stride(0), out.stride(1), float(scale),
        build.stream_handle(q.device)), "flash_mha")
    flash_mha.launches += 1
    return unpad_heads(out.reshape(*lead, Lq, num_heads * dp), num_heads, dh)


flash_mha.launches = 0


def flash_gqa_causal_reference(q, k, v, q_offset: int, length: Union[int, torch.Tensor],
                               scale: Optional[float] = None) -> torch.Tensor:
    """Plain version of :func:`flash_gqa_causal` (same signature): f32 logits
    over the whole cache with the (causal, length) mask, P in the input
    dtype. The KV heads broadcast over their query group; nothing repeats."""
    H, Lq, dh = q.shape
    Hkv, S, _ = k.shape
    group = H // Hkv
    if scale is None:
        scale = dh ** -0.5
    qg = q.reshape(Hkv, group, Lq, dh).float()
    s = torch.matmul(qg, k.float()[:, None].transpose(-1, -2)) * scale    # [Hkv, G, Lq, S]
    q_pos = q_offset + torch.arange(Lq, device=q.device)
    k_pos = torch.arange(S, device=q.device)
    length = torch.as_tensor(length, device=q.device)
    mask = (k_pos[None, :] <= q_pos[:, None]) & (k_pos[None, :] < length)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()[:, None]) / l.clamp_min(1e-30)
    return o.reshape(H, Lq, dh).to(q.dtype)


def flash_gqa_causal(
    q: torch.Tensor,              # [H, Lq, dh]   query heads
    k: torch.Tensor,              # [Hkv, S, dh]  full KV cache keys
    v: torch.Tensor,              # [Hkv, S, dh]
    q_offset: int,                # global position of q row 0 (host int)
    length: Union[int, torch.Tensor],   # count of valid keys (device scalar)
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal grouped-query attention of one prefill chunk against the
    cache. ``q`` may be a strided view (e.g. ``[L, H, dh]`` transposed);
    returns ``[H, Lq, dh]`` in q's dtype (a transposed view of an
    ``[Lq, H, dh]`` buffer on the kernel route)."""
    H, Lq, dh = q.shape
    Hkv, S, _ = k.shape
    if H % Hkv:
        raise ValueError(f"{H} query heads do not group over {Hkv} KV heads")
    if scale is None:
        scale = dh ** -0.5
    if _device_of(q, "flash_gqa_causal") == "cpu":
        return flash_gqa_causal_reference(q, k, v, q_offset, length, scale)
    if dh > K5_HEAD_DIM:
        raise ValueError(f"flash_gqa_causal kernel takes head dims up to {K5_HEAD_DIM} "
                         f"(padded), not {dh}")
    group = H // Hkv
    if group > 64 or group & (group - 1):
        raise ValueError(f"flash_gqa_causal kernel takes a group of 1, 2, 4, .., 64 query "
                         f"heads per KV head, not {group}")
    if v.shape != k.shape or k.shape[-1] != dh:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if not 0 <= int(q_offset):
        raise ValueError(f"q_offset {q_offset} < 0")
    q, k, v = (pad_last(t, K5_HEAD_DIM) for t in (q, k, v))
    dp = K5_HEAD_DIM
    out = torch.empty((Lq, H, dp), dtype=q.dtype, device=q.device).transpose(0, 1)
    _check_rows("flash_gqa_causal", q, k, v, out)
    length = torch.as_tensor(length, device=q.device).to(torch.int32).reshape(1)
    build.check(build.load_library().vgqa_flash_gqa_causal(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), length.data_ptr(),
        H, Hkv, Lq, S, dp, int(q_offset), q.stride(0), q.stride(1), k.stride(0), k.stride(1),
        v.stride(0), v.stride(1), out.stride(0), out.stride(1), float(scale),
        build.stream_handle(q.device)), "flash_gqa_causal")
    flash_gqa_causal.launches += 1
    return out if dh == dp else out[..., :dh]


flash_gqa_causal.launches = 0
