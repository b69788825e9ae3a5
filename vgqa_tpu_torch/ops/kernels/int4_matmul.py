"""Weight-only int4 group-wise matmul for decode-sized products (K6).

Replaces ``vgqa_tpu/ops/pallas/int4_matmul.py:int4_matmul`` (Pallas
``_int4_kernel``)::

    y = x [M, K] @ dequant4(packed [K/2, N], scale [n_g, N])

in the split-half pack of ``qa/quant.quantize_kernel_int4``: packed row k
holds row k in its low nibble and row K/2 + k in its high nibble; group j
of g = K / n_g rows has the f32 scale row ``scale[j]``, applied to that
group's partial sum (the low half owns groups [0, n_g/2)). Products take
the input dtype's values with f32 accumulation, as the Pallas kernel's
per-group dots do. Its callers are the seven projections of every LLM
layer of an int4 tree at decode (M = batch rows <= 64), routed by
:func:`int4_matmul_kernel_applicable`, a copy of the JAX gate, so that both
packages send the same products to the kernel: 224 launches per decode
forward of the 32-layer model. Prefill (M = 1024) stays on the plain
half-matmul form (``qa/quant.quant_matmul_int4``).

On the H100 (``csrc/int4_matmul.cu``): at M = 1 or 2 the product is two
multiply-adds per packed byte, so the bound is the packed bytes, ~109 MB
per layer (1.1 ms per decode token for 32 layers at 3.35 TB/s) with the
scales. The kernel reads each packed byte once, coalesced (4 columns per
thread, 512 per 128 threads), unpacks the nibbles in registers (no
dequantized weight reaches memory), splits the contraction in slices of
``kch`` packed rows (a divisor of g) so that enough loads are in flight,
adds up to 4 slices' scaled sums inside a block, and the last block of
each output tile to arrive (an atomic counter per tile) adds the blocks'
f32 partials in a fixed order: one launch per product, the same result
whatever order the blocks ran in. The
counters are a zeroed buffer kept per (device, stream); each launch leaves
it zero again. The Pallas wrapper pads M to 8 rows; the port takes any M.

``int4_matmul`` launches the kernel for CUDA tensors (x bf16) and runs
:func:`int4_matmul_reference` for CPU tensors; anything else raises.
``int4_matmul.launches`` counts the launches.
"""

from __future__ import annotations

import torch

from . import build

MAX_M = 64          # the gate's decode bound


def int4_matmul_kernel_applicable(m: int, k: int, n: int, n_g: int) -> bool:
    """The JAX gate (``vgqa_tpu/ops/pallas/int4_matmul.py:87``), copied
    exactly: split-half groups that tile the Pallas blocks, and
    decode-sized M only."""
    if k % 2 or n_g % 2:
        return False
    k2 = k // 2
    g = k // n_g
    k2_blk = min(512, k2)
    n_blk = min(512, n)
    return (
        g >= 1 and k2 % k2_blk == 0 and n % n_blk == 0
        and k2_blk % g == 0 and (k2 // g) * 2 == n_g
        and m <= MAX_M
    )


def unpack_int4(packed: torch.Tensor):
    """packed [K/2, N] int8 -> (low, high) int8 nibbles, sign-extended by
    arithmetic shifts (rows [0, K/2) and [K/2, K) of the weight)."""
    return (packed << 4) >> 4, packed >> 4


def int4_matmul_reference(x: torch.Tensor, packed: torch.Tensor,
                          scale: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`int4_matmul` (same signature): per-group
    partial sums in f32 of the input-dtype operands, scaled per group."""
    *lead, K = x.shape
    half, N = packed.shape
    n2 = scale.shape[0] // 2
    g = half // n2
    x2 = x.reshape(-1, K).float()
    lo, hi = unpack_int4(packed)
    y = 0.0
    for xs, w, s in ((x2[:, :half], lo, scale[:n2]), (x2[:, half:], hi, scale[n2:])):
        part = torch.einsum("mjk,jkn->mjn", xs.reshape(-1, n2, g),
                            w.float().reshape(n2, g, N))           # [M, n_g/2, N]
        y = y + (part * s.float()[None]).sum(1)
    return y.reshape(*lead, N).to(x.dtype)


def _chunk_rows(m: int, g: int) -> int:
    """Packed rows per slice: whole groups when M is large (fewer partials
    to add; the gate keeps g <= 512), 16-row slices of a group at decode
    (more blocks in flight: at M = 1 the fastest of 8, 16, 32, 64 and 128
    on the H100)."""
    if m > 8:
        return g
    return max(d for d in range(1, min(g, 16) + 1) if g % d == 0)


_ARRIVALS = {}       # (device, stream) -> zeroed uint32 tile counters


def _arrivals(device: torch.device, stream: int, tiles: int) -> torch.Tensor:
    key = (device, stream)
    buf = _ARRIVALS.get(key)
    if buf is None or buf.numel() < tiles:
        buf = torch.zeros(max(tiles, 256), dtype=torch.int32, device=device)
        _ARRIVALS[key] = buf
    return buf


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant4(packed [K/2, N], scale [n_g, N]) -> [..., N] in
    x's dtype. Leading axes fold into M; callers check
    :func:`int4_matmul_kernel_applicable` first, as in the JAX package."""
    if x.device.type == "cpu":
        return int4_matmul_reference(x, packed, scale)
    if x.device.type != "cuda":
        raise RuntimeError(f"int4_matmul runs on cpu or cuda, not {x.device}")
    *lead, K = x.shape
    half, N = packed.shape
    n_g = scale.shape[0]
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int4_matmul kernel takes bfloat16 activations, not {x.dtype}")
    if packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int4_matmul takes int8 packed and f32 scales, not "
                        f"{packed.dtype} / {scale.dtype}")
    if (K != 2 * half or scale.shape[1] != N or n_g % 2 or half % (n_g // 2)
            or packed.device != x.device or scale.device != x.device):
        raise ValueError(f"x {tuple(x.shape)}, packed {tuple(packed.shape)}, "
                         f"scale {tuple(scale.shape)}")
    x2 = x.reshape(-1, K).contiguous()
    packed, scale = packed.contiguous(), scale.contiguous()
    M = x2.shape[0]
    g = half // (n_g // 2)
    kch = _chunk_rows(M, g)
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    partial = torch.empty((half // kch, M, N), dtype=torch.float32, device=x.device)
    lib = build.load_library()
    stream = build.stream_handle(x.device)
    arrivals = _arrivals(x.device, stream, lib.vgqa_int4_matmul_tiles(M, N))
    build.check(lib.vgqa_int4_matmul(
        x2.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(), partial.data_ptr(),
        arrivals.data_ptr(), M, K, N, n_g, kch, stream), "int4_matmul")
    int4_matmul.launches += 1
    return y.reshape(*lead, N)


int4_matmul.launches = 0
