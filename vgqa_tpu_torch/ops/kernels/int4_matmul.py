"""Weight-only int4 group-wise matmul for decode-sized products (K6).

Replaces ``vgqa_tpu/ops/pallas/int4_matmul.py:int4_matmul`` (Pallas
``_int4_kernel``)::

    y = x [M, K] @ dequant4(packed [K/2, N], scale [n_g, N])

in the split-half pack of ``qa/quant.quantize_kernel_int4``: packed row k
holds row k in its low nibble and row K/2 + k in its high nibble; group j
of g = K / n_g rows has the f32 scale row ``scale[j]``, applied to that
group's f32 partial sum (the low half owns groups [0, n_g/2)); the sum is
rounded to x's dtype once. Its callers are the seven projections of every
LLM layer of an int4 tree at decode (M = batch rows <= 64), routed by
:func:`int4_matmul_kernel_applicable`, a copy of the JAX gate, so that both
packages send the same products to the kernel: 224 launches per decode
forward of the 32-layer model. Prefill (M = 1024) stays on the plain
half-matmul form (``qa/quant.quant_matmul_int4``).

On the H100 (``csrc/int4_matmul.cu``, whose header has the details): at
decode a packed byte feeds four multiply-adds, so the bound is the packed
bytes and the scales (~109 MB per layer, 1.1 ms per 32-layer token at
3.35 TB/s). The kernel contracts on the tensor cores (``mma.sync``
m16n8k16, the weight as the A operand, x's rows as B), turns nibbles into
bf16 with bit operations and one subtraction (no integer-to-float
conversions), streams each warp's steps of 16 packed rows (gcd(g, 16) for
groups of fewer rows), x and the group scales through a 4-stage
shared-memory ring of 16-byte ``cp.async`` copies, and keeps one f32
partial per group and nibble half. Each packed byte is read once for any
M <= 64. :func:`_plan` chooses, once per ``(M, K, N, n_g)``, the strip
width (16 * nt columns), the warps per block (wk) and the groups per warp
(kg) so that every projection shape fills the 132 SMs. The blocks that split one strip's contraction form a
thread-block cluster and add their f32 sums in a fixed order through
distributed shared memory: no scratch in device memory, no counters.

``int4_matmul`` launches the kernel for CUDA tensors (x bf16, any group
size g that splits the halves) and runs :func:`int4_matmul_reference` for
CPU tensors; anything else raises. ``int4_matmul.launches`` counts the launches.
"""

from __future__ import annotations

import functools
from collections import namedtuple

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


Plan = namedtuple("Plan", "nt mt wk kg strips chunks")

# The constants below were chosen by timing every plan the kernel takes at
# the four projection shapes, M = 1 and 64 (``chip_k6.py``; PERF.md §6).
_MAX_NT = 4          # strips of at most 64 columns (the kernel's widest)
_MIN_BLOCKS = 128    # narrow the strips until the groups give about one block per SM
_MAX_BLOCKS = 528    # M <= 8: more groups per warp while more blocks than fit at once (4 per SM)
_MAX_CLUSTER = 8     # the portable thread-block cluster size


@functools.lru_cache(maxsize=None)
def _plan(m: int, k: int, n: int, n_g: int) -> Plan:
    """The launch plan of one product shape (pure Python, cached).

    ``mt`` m-tiles of 8 rows hold all of x's rows; a warp owns a strip of
    ``16 * nt`` columns (``nt * mt <= 8`` bounds its f32 fragments); a block
    is ``wk`` warps on one strip, warp w taking the low-half groups
    ``[(chunk * wk + w) * kg, + kg)``; the grid is ``strips x chunks``, and
    the ``chunks`` blocks of a strip form one cluster (at most 8) that adds
    their sums."""
    mt = 1 if m <= 8 else 2 if m <= 16 else 4 if m <= 32 else 8
    n2 = n_g // 2
    wk = 4 if n2 % 4 == 0 else 2 if n2 % 2 == 0 else 1
    runs = n2 // wk                     # chunks at kg = 1

    def strips(nt):
        return -(-n // (16 * nt))

    nt = min(_MAX_NT, 8 // mt)
    while nt > 1 and strips(nt) * runs < _MIN_BLOCKS:
        nt //= 2
    kgs = [d for d in range(1, runs + 1) if runs % d == 0 and runs // d <= _MAX_CLUSTER]
    # past 8 rows a warp holds twice the fragments and fewer blocks fit: the
    # fewest blocks from about one per SM up
    cap = _MAX_BLOCKS if mt == 1 else _MIN_BLOCKS
    fits = [d for d in kgs if strips(nt) * (runs // d) <= cap]
    kg = min(fits) if fits else max(kgs)
    return Plan(nt, mt, wk, kg, strips(nt), runs // kg)


@functools.lru_cache(maxsize=None)
def _checked_plan(m: int, k: int, half: int, n: int, n_g: int, scale_cols: int) -> Plan:
    """:func:`_plan` for shapes the kernel takes; raises ValueError otherwise."""
    if not 1 <= m <= MAX_M:
        raise ValueError(f"int4_matmul takes 1 to {MAX_M} rows, not {m}")
    if k != 2 * half or scale_cols != n or n_g < 2 or n_g % 2 or half % (n_g // 2):
        raise ValueError(f"int4_matmul: K {k}, packed [{half}, {n}], scale [{n_g}, "
                         f"{scale_cols}]")
    return _plan(m, k, n, n_g)


def int4_matmul(x: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ dequant4(packed [K/2, N], scale [n_g, N]) -> [..., N] in
    x's dtype. Leading axes fold into M; callers check
    :func:`int4_matmul_kernel_applicable` first, as in the JAX package.
    The launch path is kept short: decode calls it 224 times per token."""
    dev = x.device
    if dev.type != "cuda":
        if dev.type == "cpu":
            return int4_matmul_reference(x, packed, scale)
        raise RuntimeError(f"int4_matmul runs on cpu or cuda, not {dev}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"int4_matmul kernel takes bfloat16 activations, not {x.dtype}")
    if packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int4_matmul takes int8 packed and f32 scales, not "
                        f"{packed.dtype} / {scale.dtype}")
    K = x.shape[-1]
    M = x.numel() // K
    half, N = packed.shape
    plan = _checked_plan(M, K, half, N, *scale.shape)
    if packed.device != dev or scale.device != dev:
        raise ValueError(f"int4_matmul: x on {dev}, packed on {packed.device}, "
                         f"scale on {scale.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        x = x.clone(memory_format=torch.contiguous_format)
    if not packed.is_contiguous() or packed.data_ptr() % 16:
        packed = packed.clone(memory_format=torch.contiguous_format)
    if not scale.is_contiguous() or scale.data_ptr() % 16:
        scale = scale.clone(memory_format=torch.contiguous_format)
    y = torch.empty((*x.shape[:-1], N), dtype=torch.bfloat16, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)   # the handle, as an int
    build.check(build.load_library().vgqa_int4_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(), M, K, N,
        scale.shape[0], plan.nt, plan.wk, plan.kg, stream), "int4_matmul")
    int4_matmul.launches += 1
    return y


int4_matmul.launches = 0
