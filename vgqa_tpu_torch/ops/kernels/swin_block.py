"""One whole Video Swin block, on a window-padded canvas or on windows.

Replaces two kernels of ``vgqa_tpu/ops/pallas/swin_block.py`` that share
their math (``_compute_block`` and ``_tail``):

* ``swin_block_canvas`` (body ``_body_canvas``) reads the windows of
  ``roll(canvas, -roll)`` and writes its output in the rolled frame (the
  caller unrolls once per stage);
* ``swin_block_fused`` (body ``_body_sliced``) takes windows ``[W, N, C]``
  that were partitioned outside and gives windows back.

Both compute

    LN1 -> x valid -> qkv (scale folded into q) -> per-window MHA with the
    rel-pos bias [H, N, N] and the SW-MSA region mask -> proj -> residual ->
    LN2 -> fc1 -> exact GELU -> fc2 -> residual

and the canvas block takes optional per-sample DropPath branch gates
``[B, 2]``. The serving path runs the canvas block 12 times per forward:
C = 96/192/384/768 with 3/6/12/24 heads of 32, windows of 8x7x7 = 392
tokens, canvases of V = 2 clips x 64 frames. The windowed block serves
``models/video_swin.py:fused_block_apply``, one block per call.

On the H100 the block is bound by the bytes of its intermediates at
Swin-T's stages 0-1 (C = 96, 192: every linear layer is under the card's
~295 flop per byte; the seven launches move about 26 C-wide rows per token)
and by its products at stages 2-3 (the four linear layers carry ~8x the
multiply-adds of the attention). A plain PyTorch version also moves the
[N, N] logits and probabilities of every head through device memory, plus a
copy for each roll and window (un)partition. The port is one short chain of
hand-written launches, all products on the tensor cores with f32
accumulation, entered with row maps for the canvas and without them for
windows:

1. ``ln_rows_kernel`` (``csrc/kernels.cu``) reads each window token from
   its source row (for the canvas a cached row map replaces roll +
   partition; windows are read in place), applies LN1 and the ``valid``
   mask, and writes the tokens in window order;
2. ``gemm_sm90_kernel`` (``csrc/gemm_sm90.cu``: wgmma on TMA-fed 64-byte
   swizzled k-steps, a producer warp and two consumer warpgroups, W
   resident in shared memory where it fits, an N tile that divides N, the
   epilogue staged through shared memory into 16-byte row stores) computes
   qkv (scale folded into the q columns); its launch plan is
   :func:`gemm_plan`;
3. ``window_attn_sm90_kernel`` (``csrc/window_attn_sm90.cu``, K2's Hopper
   kernel in its terms form: rel-pos bias and region ids) runs the
   attention, one block per (window, head) with its Q, K and V loaded once,
   an online softmax in registers, so logits and probabilities never reach
   device memory;
4. ``gemm_sm90_kernel`` computes proj with bias, gate and the residual read
   from the source rows fused in its epilogue;
5. ``ln_rows_kernel`` computes LN2;
6. ``gemm_sm90_kernel`` computes fc1 with bias and exact ``erff`` GELU;
7. ``gemm_sm90_kernel`` computes fc2 with bias, gate and residual, and
   writes each token to its output row (for the canvas, its canvas row in
   the rolled frame).

A null row map is the identity in both kernels, so the windowed block
passes none and allocates no M-long index map per call.

The rounding points follow the TPU kernel (bf16 after each product and
bias, P rounded to bf16 for P.V, f32 LayerNorm/softmax/GELU). One
difference: the TPU kernel skips the softmax max-subtraction and clamps
logits at 80 (a VPU saving); this port subtracts the running row max
instead, which is exact for any logits.

In float32 (``TPU.TRAIN_DTYPE float32``, the default, and
``TPU.COMPUTE_DTYPE float32``) the chain runs the same seven launches
through the kernels' float32 forms, every rounding point an identity, as
the JAX kernel at f32: ``ln_rows_kernel<float>``, the GEMM as 3xTF32
(``gemm_sm90_kernel<true, ...>``: A_hi W_hi + A_hi W_lo + A_lo W_hi on
tf32 wgmma with f32 accumulation, each operand split by :func:`tf32_split`;
W's split is cached per weight, keyed on its storage and version) and
``window_attn_f32_kernel`` (FFMA, bound by the 67 TFLOP/s FFMA rate).

``swin_block_canvas`` / ``swin_block_fused`` launch the chain for CUDA
tensors (bf16 or f32, head dim 32) and run ``swin_block_canvas_reference``
/ ``swin_block_fused_reference`` for CPU tensors; anything else raises.
"""

from __future__ import annotations

import collections
import functools
import weakref
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import build
from . import window_attention as wa
from .dtypes import check_kernel_dtype

LN_EPS = 1e-5
_EPI_BIAS, _EPI_GELU, _EPI_RES_GATHER, _EPI_RES_SCATTER = 0, 1, 2, 3

# csrc/gemm_sm90.cu's plan space: M tiles of 128 rows, k-steps of 64-byte
# rows (32 bf16 or 16 float), the N tiles the kernel is compiled for (the
# widest first) and the wgmma width of each, an H100 block's shared memory
# (the card tests hold these, and gemm_smem_bytes, against the library's
# own G_TILES table and formula: vgqa_gemm_sm90_tiles / _smem_bytes / _smem_max)
GEMM_BM = 128
GEMM_ROW_BYTES = 64
GEMM_BNS = (192, 144, 128, 96, 64, 32)
GEMM_WN = {192: 96, 144: 48, 128: 64, 96: 96, 64: 64, 32: 32}
GEMM_SMEM_MAX = 232_448
GEMM_SMEM_MAX2 = 115_712       # each of two blocks on an SM: (233,472 - 2 x 1,024) / 2
H100_SMS = 132
# H100 SXM rates the plan weighs a layer's bytes against its products with
GEMM_PEAK_BF16, GEMM_PEAK_TF32, GEMM_PEAK_BYTES = 989e12, 494.7e12, 3.35e12


def gemm_smem_bytes(f32: bool, bn: int, stages: int, kps: int, resident: bool,
                    ksteps: int) -> int:
    """Shared memory of a plan, as ``gemm_smem_bytes`` in csrc/gemm_sm90.cu:
    alignment slack, the A ring of ``stages`` slots of ``kps`` k-steps (and
    its lo halves in float32), W (every k-step when resident, else those of
    each slot; hi and lo in float32), the N tile's bias, the epilogue's
    staging rows (32 per consumer warpgroup) and the mbarriers."""
    dup = 2 if f32 else 1
    return (1024 + stages * kps * GEMM_BM * GEMM_ROW_BYTES * dup
            + (ksteps if resident else stages * kps) * bn * GEMM_ROW_BYTES * dup
            + 4 * bn + 2 * 32 * (bn * (4 if f32 else 2) + 16) + 8 * (2 * stages + 1))


def gemm_plan(M: int, N: int, K: int, f32: bool, num_sms: int = H100_SMS) -> dict:
    """The launch plan of ``gemm_sm90_kernel`` for ``out[M, N] = A[M, K] @
    W[N, K]^T``, which :func:`_gemm` passes to the kernel.

    The N tile ``bn`` divides N (N % 32 == 0: K1's layers are multiples of
    the head dim), so no product is computed past N; a k-step is one
    64-byte row (32 bf16, 16 float), so K is never padded. A ring slot
    holds ``kps`` k-steps (the most of 4, 3, 2, 1 that divides the k-steps
    and leaves at least 3 slots), so one barrier wait and one commit cover
    them while the producer loads two slots ahead. A layer bound by its
    bytes (Swin-T's stages 0-1) keeps W ``resident`` (all of its k-steps of
    the N tile loaded once per block, the grid persistent over the M tiles)
    beside at least 3 slots of A: a tile of min(96, N) columns if two blocks
    then fit on an SM (``bps`` 2: twice the warps in the epilogue, which
    moves most of its bytes), else the widest tile of at least min(96, N)
    columns. A layer bound by its products, and one whose W does not fit,
    streams W beside A through the ring (from L2) in the widest tile, where
    the ring has room for more k-steps per slot. The grid is the N tiles times as
    many M groups as fill the card's SMs. Raises ``ValueError`` for a shape
    the kernel does not take."""
    bke = GEMM_ROW_BYTES // (4 if f32 else 2)
    if M < 1 or N < 32 or N % 32 or K < bke or K % bke:
        raise ValueError(f"gemm kernel takes N % 32 == 0 and K % {bke} == 0, "
                         f"not M={M} N={N} K={K}")
    dup = 2 if f32 else 1
    elem = 4 if f32 else 2
    a_step = GEMM_BM * GEMM_ROW_BYTES * dup
    ksteps = K // bke
    kpss = [k for k in (4, 3, 2, 1) if ksteps % k == 0]
    cands = [bn for bn in GEMM_BNS if N % bn == 0]
    # 3xTF32 runs three tf32 products at the dense TF32 rate
    t_ops = 2.0 * M * N * K / (GEMM_PEAK_TF32 / 3 if f32 else GEMM_PEAK_BF16)
    byte_bound = (M * K + N * K + M * N) * elem / GEMM_PEAK_BYTES > t_ops

    def resident_plan(bn, cap):
        for kps in kpss:
            free = cap - gemm_smem_bytes(f32, bn, 0, kps, True, ksteps) - 16
            n = min(8, free // (kps * a_step + 16))
            if n >= 3:
                return bn, n, kps, True
        return None

    plan, bps = None, 1
    if byte_bound and min(96, N) in cands:
        plan = resident_plan(min(96, N), GEMM_SMEM_MAX2)
        bps = 2 if plan else 1
    if plan is None and byte_bound:
        for bn in cands:
            if bn < min(96, cands[0]):
                break
            plan = resident_plan(bn, GEMM_SMEM_MAX)
            if plan:
                break
    if plan is None:
        bn = cands[0]
        w_step = bn * GEMM_ROW_BYTES * dup
        for kps in kpss:
            free = GEMM_SMEM_MAX - gemm_smem_bytes(f32, bn, 0, kps, False, ksteps) - 16
            n = min(6, free // (kps * (a_step + w_step) + 16))
            if n >= 3 or (kps == 1 and n >= 2):
                plan = (bn, n, kps, False)
                break
    if plan is None:
        raise ValueError(f"gemm kernel has no plan for M={M} N={N} K={K}")
    bn, stages, kps, resident = plan
    smem = gemm_smem_bytes(f32, bn, stages, kps, resident, ksteps)
    assert smem <= (GEMM_SMEM_MAX2 if bps == 2 else GEMM_SMEM_MAX)
    n_tiles = N // bn
    m_tiles = -(-M // GEMM_BM)
    groups = max(1, min(m_tiles, bps * num_sms // n_tiles))
    return {"bn": bn, "wn": GEMM_WN[bn], "stages": stages, "kps": kps, "resident": resident,
            "bps": bps, "smem": smem, "ksteps": ksteps, "n_tiles": n_tiles,
            "m_tiles": m_tiles, "grid": n_tiles * groups}


def tf32_split(x: torch.Tensor):
    """float32 ``x`` as ``(hi, lo)``: ``hi`` rounded to tf32 (nearest, ties
    away from zero; the low 13 bits zero), ``lo = x - hi`` (exact in f32),
    as ``gemm_sm90_kernel``'s 3xTF32 form splits both operands."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    return hi, x - hi


def _partition(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """[B, D, H, W, ...] -> [B * nW, wd*wh*ww, ...] in (a, bh, wi) window order."""
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


def _fold_q_scale(w_in_out: torch.Tensor, b: torch.Tensor, C: int, scale: float):
    """Scale the q columns of the qkv weight [C, 3C] and bias, rounded to
    their dtype (as the TPU kernel does once per call)."""
    w = torch.cat([(w_in_out[:, :C].float() * scale).to(w_in_out.dtype),
                   w_in_out[:, C:]], dim=1)
    b = torch.cat([(b[:C].float() * scale).to(b.dtype), b[C:]])
    return w, b


def _ln(x: torch.Tensor, scale, bias) -> torch.Tensor:
    return F.layer_norm(x.float(), x.shape[-1:], scale.float(), bias.float(),
                        LN_EPS)


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w with f32 accumulation (w in the JAX [in, out] layout)."""
    return torch.matmul(a.float(), w.float())


def _tile_windows(vec: Optional[torch.Tensor], nW: int):
    if vec is None:
        return None
    if vec.shape[0] != nW:
        if nW % vec.shape[0]:
            raise ValueError(f"{vec.shape[0]} rows do not tile {nW} windows")
        vec = vec.repeat(nW // vec.shape[0], 1)
    return vec


def _block_on_windows(xx, ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj,
                      ln2_scale, ln2_bias, wfc1, bfc1, wfc2, bfc2, bias,
                      num_heads, region, valid, gates) -> torch.Tensor:
    """The block's math on windows ``xx`` [W, N, C], shared by both plain
    versions. ``region``/``valid`` [rows, N]: window w reads row w % rows;
    ``gates`` [W, 2] per window or None."""
    W, N, C = xx.shape
    dt = xx.dtype
    h = _ln(xx, ln1_scale, ln1_bias)
    if valid is not None:
        h = h * wa._tile_rows(valid, W).float()[..., None]
    h = h.to(dt)

    wq, bq = _fold_q_scale(wqkv, bqkv, C, (C // num_heads) ** -0.5)
    qkv = _mm(h, wq).to(dt) + bq.to(dt)
    attn = wa.window_attention_reference(
        qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:], bias, region, None,
        num_heads, scale=1.0)

    proj = _mm(attn, wproj).to(dt) + bproj.to(dt)
    if gates is not None:
        proj = proj * gates[:, 0, None, None].to(dt)
    x1 = xx + proj
    h2 = _ln(x1, ln2_scale, ln2_bias).to(dt)
    f = F.gelu(_mm(h2, wfc1) + bfc1.float(), approximate="none").to(dt)
    f = _mm(f, wfc2).to(dt) + bfc2.to(dt)
    if gates is not None:
        f = f * gates[:, 1, None, None].to(dt)
    return x1 + f


def swin_block_canvas_reference(
    canvas: torch.Tensor,                 # [B, Dp, Hp, Wp, C] window-padded
    ln1_scale, ln1_bias,
    wqkv, bqkv, wproj, bproj,             # [C, 3C], [3C], [C, C], [C]
    ln2_scale, ln2_bias,
    wfc1, bfc1, wfc2, bfc2,               # [C, 4C], [4C], [4C, C], [C]
    bias: torch.Tensor,                   # [H, N, N] rel-pos bias
    num_heads: int,
    window: Sequence[int],                # (wd, wh, ww), already dim-clamped
    roll: Sequence[int],                  # read = roll(canvas, -roll)
    region: Optional[torch.Tensor] = None,  # [nW, N] ids in the rolled frame
    valid: Optional[torch.Tensor] = None,   # [nW, N] 1 = real token
    gates: Optional[torch.Tensor] = None,   # [B, 2] DropPath branch gates
) -> torch.Tensor:
    """Plain PyTorch version of :func:`swin_block_canvas` (same signature).
    Weights use the JAX ``[in, out]`` layout."""
    B, Dp, Hp, Wp, C = canvas.shape
    wd, wh, ww = window
    if Dp % wd or Hp % wh or Wp % ww:
        raise ValueError(f"canvas {tuple(canvas.shape)} is not window-padded for {window}")
    nW = (Dp // wd) * (Hp // wh) * (Wp // ww)
    rd, rh, rw = (int(r) % s for r, s in zip(roll, (Dp, Hp, Wp)))
    x = torch.roll(canvas, shifts=(-rd, -rh, -rw), dims=(1, 2, 3))
    g = None if gates is None else gates.float().repeat_interleave(nW, dim=0)
    out = _block_on_windows(
        _partition(x, window), ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj,
        ln2_scale, ln2_bias, wfc1, bfc1, wfc2, bfc2, bias, num_heads, region,
        _tile_windows(valid, nW), g)
    return _reverse(out, window, B, Dp, Hp, Wp)


def swin_block_fused_reference(
    x: torch.Tensor,                      # [W, N, C] partitioned windows
    ln1_scale, ln1_bias,
    wqkv, bqkv, wproj, bproj,             # [C, 3C], [3C], [C, C], [C]
    ln2_scale, ln2_bias,
    wfc1, bfc1, wfc2, bfc2,               # [C, 4C], [4C], [4C, C], [C]
    bias: torch.Tensor,                   # [H, N, N] rel-pos bias
    num_heads: int,
    region: Optional[torch.Tensor] = None,  # [W or nW, N] SW-MSA region ids
    valid: Optional[torch.Tensor] = None,   # [W or nW, N] 1 = real token
) -> torch.Tensor:
    """Plain PyTorch version of :func:`swin_block_fused` (same signature).
    Weights use the JAX ``[in, out]`` layout; window w reads row w % rows
    of ``region`` and ``valid``."""
    return _block_on_windows(x, ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj,
                             ln2_scale, ln2_bias, wfc1, bfc1, wfc2, bfc2, bias,
                             num_heads, region, valid, None)


@functools.lru_cache(maxsize=64)
def _row_maps(B, Dp, Hp, Wp, window, roll, device):
    """Canvas row of every window-order token: (read map with the roll,
    write map in the rolled frame), int32 on ``device``."""
    idx = torch.arange(B * Dp * Hp * Wp, device=device, dtype=torch.int32)
    idx = idx.reshape(B, Dp, Hp, Wp)
    rolled = torch.roll(idx, shifts=tuple(-r for r in roll), dims=(1, 2, 3))
    return (_partition(rolled, window).reshape(-1).contiguous(),
            _partition(idx, window).reshape(-1).contiguous())


# weight operands of the GEMM, [out, in] rows (float32: the tf32 split),
# per source weight; keyed on its storage, offset, layout and version
# counter (a weight changed in place is never read stale), and dropped when
# the tensor that owns the storage is freed (its address could then be
# reused under the same key)
_WEIGHTS: "collections.OrderedDict" = collections.OrderedDict()
_WEIGHTS_KEPT = 128


def _weight_operands(w: torch.Tensor, dev, dt, q_scale: Optional[float] = None):
    """``(w_nk, w_lo)``: the ``[in, out]`` weight ``w`` as ``[out, in]`` rows
    in ``dt`` on ``dev`` (the q columns scaled by ``q_scale`` and rounded,
    as :func:`_fold_q_scale`), and for float32 its tf32 split (``w_nk`` the
    hi half, ``w_lo`` the lo); ``w_lo`` is None for bf16."""
    key = (w.untyped_storage().data_ptr(), w.storage_offset(), tuple(w.shape), w.stride(),
           w.dtype, w._version, str(dev), dt, q_scale)
    hit = _WEIGHTS.get(key)
    if hit is not None:
        _WEIGHTS.move_to_end(key)
        return hit
    with torch.no_grad():
        src = w.detach()
        if q_scale is not None:
            C = src.shape[0]
            src = torch.cat([(src[:, :C].float() * q_scale).to(src.dtype), src[:, C:]], dim=1)
        w_nk = src.to(device=dev, dtype=dt).t().contiguous()
        ops = tf32_split(w_nk) if dt == torch.float32 else (w_nk, None)
    _WEIGHTS[key] = ops
    weakref.finalize(w if w._base is None else w._base, _WEIGHTS.pop, key, None)
    if len(_WEIGHTS) > _WEIGHTS_KEPT:
        _WEIGHTS.popitem(last=False)
    return ops


@functools.lru_cache(maxsize=8)
def _num_sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _gemm(lib, stream, a, w_ops, bias, out, ldo, mode, res=None, ldr=0,
          rowmap=None, gates=None, gate_col=0, rows_per_sample=1):
    w_nk, w_lo = w_ops
    M, K = a.shape
    N = w_nk.shape[0]
    f32 = a.dtype == torch.float32
    align = 4 if f32 else 8                   # elements of 16 bytes
    if (a.stride(1) != 1 or a.stride(0) % align or ldo % align or ldr % align
            or a.data_ptr() % 16 or out.data_ptr() % 16 or (res is not None and res.data_ptr() % 16)):
        raise ValueError("gemm kernel needs 16-byte aligned rows of A, out and res")
    plan = gemm_plan(M, N, K, f32, _num_sms(a.device))
    entry = lib.vgqa_gemm_sm90_f32 if f32 else lib.vgqa_gemm_sm90
    build.check(entry(
        a.data_ptr(), a.stride(0), w_nk.data_ptr(), build.ptr(w_lo), w_nk.stride(0),
        build.ptr(bias), out.data_ptr(), ldo, M, N, K, mode,
        build.ptr(res), ldr, build.ptr(rowmap), build.ptr(gates), gate_col,
        rows_per_sample, plan["bn"], plan["stages"], plan["kps"], int(plan["resident"]),
        plan["bps"], plan["grid"], stream), "swin block gemm")


def _ln_rows(lib, stream, x, rowmap, scale, bias, valid, n_valid, out, M, C):
    entry = lib.vgqa_ln_rows_f32 if x.dtype == torch.float32 else lib.vgqa_ln_rows
    build.check(entry(
        x.data_ptr(), build.ptr(rowmap), scale.data_ptr(), bias.data_ptr(),
        build.ptr(valid), n_valid, out.data_ptr(), M, C, LN_EPS, stream),
        f"swin block layernorm (takes C = 32 x 1, 2, 3, 4, 6, 8, 12, 16, 24 or 32; C = {C})")


def _takes_kernel(name: str, x: torch.Tensor, C: int, num_heads: int) -> bool:
    """True for a CUDA tensor the kernel takes, False for a CPU tensor (the
    plain version); raises for anything else."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise RuntimeError(f"{name} runs on cpu or cuda, not {x.device}")
    check_kernel_dtype(f"{name} kernel", x.dtype)
    if C // num_heads != wa.HEAD_DIM or C % num_heads:
        raise ValueError(f"{name} kernel takes head dim {wa.HEAD_DIM}")
    return True


def _launch_chain(src, out, W, N, weights, bias, num_heads, region, valid,
                  read_map=None, write_map=None, gates=None, rows_per_sample=1):
    """The seven launches of one block over W windows of N tokens: token m
    (window order) reads row ``read_map[m]`` of ``src`` [rows, C] and is
    written to row ``write_map[m]`` of ``out`` (row m where a map is None).
    ``valid`` [rows, N] reaches LN1 flat, token m reading entry
    m % (rows * N)."""
    (ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj,
     ln2_scale, ln2_bias, wfc1, bfc1, wfc2, bfc2) = weights
    C = src.shape[-1]
    M = W * N
    dev, dt = src.device, src.dtype     # the chain runs in the input's dtype

    def vec(t):
        return t.to(device=dev, dtype=dt).contiguous()

    scale = wa.HEAD_DIM ** -0.5
    bq = torch.cat([(bqkv[:C].float() * scale).to(bqkv.dtype), bqkv[C:]])
    n_valid = 1
    if valid is not None:
        valid = valid.to(device=dev, dtype=torch.float32).reshape(-1).contiguous()
        n_valid = valid.numel()
    if gates is not None:
        gates = gates.to(device=dev, dtype=torch.float32).contiguous()

    lib = build.load_library()
    st = build.stream_handle(dev)
    h = torch.empty((M, C), dtype=dt, device=dev)
    _ln_rows(lib, st, src, read_map, vec(ln1_scale), vec(ln1_bias), valid, n_valid,
             h, M, C)
    qkv = torch.empty((M, 3 * C), dtype=dt, device=dev)
    _gemm(lib, st, h, _weight_operands(wqkv, dev, dt, scale), vec(bq), qkv, 3 * C, _EPI_BIAS)
    attn = torch.empty((M, C), dtype=dt, device=dev)
    q3 = qkv.view(W, N, 3 * C)
    wa.launch(q3[..., :C], q3[..., C:2 * C], q3[..., 2 * C:],
              attn.view(W, N, C), num_heads, 1.0, bias=vec(bias), region=region)
    x1 = torch.empty((M, C), dtype=dt, device=dev)
    _gemm(lib, st, attn, _weight_operands(wproj, dev, dt), vec(bproj), x1, C, _EPI_RES_GATHER,
          res=src, ldr=C, rowmap=read_map, gates=gates, gate_col=0,
          rows_per_sample=rows_per_sample)
    h2 = torch.empty((M, C), dtype=dt, device=dev)
    _ln_rows(lib, st, x1, None, vec(ln2_scale), vec(ln2_bias), None, 1, h2, M, C)
    f = torch.empty((M, wfc1.shape[1]), dtype=dt, device=dev)
    _gemm(lib, st, h2, _weight_operands(wfc1, dev, dt), vec(bfc1), f, f.shape[1], _EPI_GELU)
    _gemm(lib, st, f, _weight_operands(wfc2, dev, dt), vec(bfc2), out, C, _EPI_RES_SCATTER,
          res=x1, ldr=C, rowmap=write_map, gates=gates, gate_col=1,
          rows_per_sample=rows_per_sample)


def swin_block_canvas(
    canvas: torch.Tensor,
    ln1_scale, ln1_bias,
    wqkv, bqkv, wproj, bproj,
    ln2_scale, ln2_bias,
    wfc1, bfc1, wfc2, bfc2,
    bias: torch.Tensor,
    num_heads: int,
    window: Sequence[int],
    roll: Sequence[int],
    region: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
    gates: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One Swin block over the canvas; see the module docstring. Weights use
    the JAX ``[in, out]`` layout (pass ``linear.weight.t()``: no copy)."""
    weights = (ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj, ln2_scale, ln2_bias,
               wfc1, bfc1, wfc2, bfc2)
    B, Dp, Hp, Wp, C = canvas.shape
    if not _takes_kernel("swin_block_canvas", canvas, C, num_heads):
        return swin_block_canvas_reference(canvas, *weights, bias, num_heads, window,
                                           roll, region, valid, gates)
    wd, wh, ww = (int(w) for w in window)
    if Dp % wd or Hp % wh or Wp % ww:
        raise ValueError(f"canvas {tuple(canvas.shape)} is not window-padded for {window}")
    N = wd * wh * ww
    nW = (Dp // wd) * (Hp // wh) * (Wp // ww)
    roll = tuple(int(r) % s for r, s in zip(roll, (Dp, Hp, Wp)))
    read_map, write_map = _row_maps(B, Dp, Hp, Wp, (wd, wh, ww), roll, canvas.device)
    if gates is not None and tuple(gates.shape) != (B, 2):
        raise ValueError(f"gates shape {tuple(gates.shape)} != {(B, 2)}")

    canvas = canvas.contiguous()
    out = torch.empty_like(canvas)
    _launch_chain(canvas, out, B * nW, N, weights, bias, num_heads, region,
                  _tile_windows(valid, nW), read_map, write_map, gates,
                  rows_per_sample=nW * N)
    swin_block_canvas.launches += 1
    return out


swin_block_canvas.launches = 0


def swin_block_fused(
    x: torch.Tensor,
    ln1_scale, ln1_bias,
    wqkv, bqkv, wproj, bproj,
    ln2_scale, ln2_bias,
    wfc1, bfc1, wfc2, bfc2,
    bias: torch.Tensor,
    num_heads: int,
    region: Optional[torch.Tensor] = None,
    valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One Swin block on partitioned windows ``x`` [W, N, C]; see the module
    docstring. Weights use the JAX ``[in, out]`` layout; ``region`` and
    ``valid`` hold W or a divisor of W rows (window w reads row w % rows)."""
    weights = (ln1_scale, ln1_bias, wqkv, bqkv, wproj, bproj, ln2_scale, ln2_bias,
               wfc1, bfc1, wfc2, bfc2)
    W, N, C = x.shape
    if not _takes_kernel("swin_block_fused", x, C, num_heads):
        return swin_block_fused_reference(x, *weights, bias, num_heads, region, valid)
    if valid is not None and (valid.shape[-1] != N or W % valid.shape[0]):
        raise ValueError(f"valid shape {tuple(valid.shape)} does not fit {W}x{N}")
    x = x.contiguous()
    out = torch.empty_like(x)
    _launch_chain(x, out, W, N, weights, bias, num_heads, region, valid)
    swin_block_fused.launches += 1
    return out


swin_block_fused.launches = 0
