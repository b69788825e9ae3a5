"""Peaks of one NVIDIA H100 SXM and the least time each hand-written kernel
needs at the shapes a cell drives: the yardstick of the ``*_roofline``
metrics.

The peaks are NVIDIA's data sheet figures (dense rates, 700 W): 989 TFLOP/s
bf16, 494.7 TFLOP/s TF32, 67 TFLOP/s float32 on the FFMA units, 3.35 TB/s
of HBM3. A kernel's bound is the larger of its operations over the peak of
their type and its bytes over the memory rate, each input read once and
each output written once. The formulas are those the port's smoke run
(``chip_smoke.py``: ``bound``, ``k1_bound``, the f32 K1 design bound, and the
K2-K5 counts) uses, copied here so that the yardstick cannot move with the
program.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

PEAK_BF16 = 989e12
PEAK_TF32 = 494.7e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """Least seconds of a kernel on one H100 SXM."""
    return max(flops / peak, nbytes / PEAK_BYTES)


# -- K1: one Video Swin block on its window-padded canvas -------------------------
def _adjust_window(dims, window, shift):
    w, s = list(window), list(shift)
    for i in range(3):
        if dims[i] <= window[i]:
            w[i], s[i] = dims[i], 0
    return tuple(w), tuple(s)


def swin_blocks(frames: int, res: int, patch=(1, 4, 4), embed_dim: int = 96,
                depths: Sequence[int] = (2, 2, 6, 2), heads: Sequence[int] = (3, 6, 12, 24),
                window=(8, 7, 7)) -> List[Tuple[Tuple[int, int, int], int, int, int]]:
    """(padded dims, C, heads, N) of every block of a Video Swin tower over
    ``frames`` frames of ``res`` px (patch merging halves H and W, rounding
    up)."""
    dims = (math.ceil(frames / patch[0]), math.ceil(res / patch[1]), math.ceil(res / patch[2]))
    out = []
    for s, depth in enumerate(depths):
        if s:
            dims = (dims[0], math.ceil(dims[1] / 2), math.ceil(dims[2] / 2))
        win, _ = _adjust_window(dims, window, (0, 0, 0))
        padded = tuple(d + (-d) % w for d, w in zip(dims, win))
        n = win[0] * win[1] * win[2]
        for _ in range(depth):
            out.append((padded, embed_dim * 2 ** s, heads[s], n))
    return out


def k1_bound_s(batch: int, padded, C: int, N: int, heads: int) -> float:
    """bf16 K1 call: the four linear layers and the attention products;
    bytes: tokens in and out, the weights, the bias."""
    tokens = batch * padded[0] * padded[1] * padded[2]
    flops = tokens * (24.0 * C * C + 4.0 * N * C)
    nbytes = 2 * tokens * C * 2 + 12 * C * C * 2 + heads * N * N * 2
    return bound_s(flops, nbytes)


def k1_f32_bound_s(batch: int, padded, C: int, N: int, heads: int) -> float:
    """float32 K1 call, the bound of its design: the GEMM's three TF32
    products at the TF32 rate, the attention at the FFMA rate, or the bytes."""
    tokens = batch * padded[0] * padded[1] * padded[2]
    nbytes = 2 * tokens * C * 4 + 12 * C * C * 4 + heads * N * N * 4
    ops = 3 * tokens * 24.0 * C * C / PEAK_TF32 + tokens * 4.0 * N * C / PEAK_F32
    return max(ops, nbytes / PEAK_BYTES)


def k1_tower_bound_s(frames: int, res: int, batch: int, f32: bool = False) -> float:
    fn = k1_f32_bound_s if f32 else k1_bound_s
    return sum(fn(batch, padded, C, N, h) for padded, C, h, N in swin_blocks(frames, res))


# -- K2: windowed attention of the encoder (eval) ---------------------------------
def k2_bound_s(rows: int, S: int, C: int) -> float:
    """bf16 K2 call over ``rows`` rows of S tokens, C channels, key mask."""
    return bound_s(4.0 * rows * S * S * C, 4 * rows * S * C * 2 + rows * S * 4)


# -- K3: training attention, forward and backward (float32 forms) -----------------
def k3_f32_bound_s(rows: int, heads: int, L: int, D: int) -> float:
    """float32 K3 forward + backward over ``rows`` rows x ``heads`` heads,
    L tokens, head dim D, at the FFMA rate."""
    B = rows * heads
    elems = B * L * D
    fwd = bound_s(4.0 * B * L * L * D, 4 * elems * 4 + B * L * 4 + rows * L, PEAK_F32)
    bwd = bound_s(10.0 * B * L * L * D, 8 * elems * 4 + B * L * 4 + rows * L, PEAK_F32)
    return fwd + bwd


# -- K4: the ViT's attention ------------------------------------------------------
def k4_bound_s(tiles: int, heads: int, L: int, D: int) -> float:
    return bound_s(4.0 * tiles * heads * L * L * D, 4 * tiles * L * heads * D * 2)


# -- K5: one causal GQA prefill chunk ----------------------------------------------
def k5_chunk_bound_s(q_offset: int, Lq: int, length: int, S: int, H: int = 32,
                     Hkv: int = 8, D: int = 128) -> float:
    """Operations over the keys the chunk's queries may see; bytes: q and
    the output, and the keys and values read."""
    valid = sum(min(q_offset + r + 1, length) for r in range(Lq))
    kread = min(q_offset + Lq, length, S)
    return bound_s(4.0 * H * D * valid, 2 * H * Lq * D * 2 + 2 * Hkv * kread * D * 2)


def k5_prefill_bound_s(length: int, chunk: int = 1024, S: int = 9216, layers: int = 32,
                       **kw) -> float:
    """All K5 calls of one chunked prefill of ``length`` prompt tokens."""
    n_chunks = -(-length // chunk)
    return layers * sum(k5_chunk_bound_s(i * chunk, chunk, length, S, **kw)
                        for i in range(n_chunks))
