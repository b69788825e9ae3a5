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

On the H100 the block is bound by its products (the four linear layers
carry ~8x the multiply-adds of the attention) and by the bytes of its
intermediates: a plain PyTorch version also moves the [N, N] logits and
probabilities of every head through device memory, plus a copy for each
roll and window (un)partition. The port is one short chain of hand-written
launches (``csrc/kernels.cu``), all products on the tensor cores with f32
accumulation, entered with row maps for the canvas and without them for
windows:

1. ``ln_rows_kernel`` reads each window token from its source row (for the
   canvas a cached row map replaces roll + partition; windows are read in
   place), applies LN1 and the ``valid`` mask, and writes the tokens in
   window order;
2. ``gemm_bf16_kernel`` computes qkv (scale folded into the q columns);
3. ``window_attn_kernel`` runs the attention per (window, head) with an
   online softmax in registers, so logits and probabilities never reach
   device memory;
4. ``gemm_bf16_kernel`` computes proj with bias, gate and the residual read
   from the source rows fused in its epilogue;
5. ``ln_rows_kernel`` computes LN2;
6. ``gemm_bf16_kernel`` computes fc1 with bias and exact ``erff`` GELU;
7. ``gemm_bf16_kernel`` computes fc2 with bias, gate and residual, and
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
through the kernels' float32 forms (``ln_rows_kernel<float>``,
``gemm_f32_kernel``, ``window_attn_f32_kernel``): FFMA products, every
rounding point an identity, as the JAX kernel at f32. That chain is bound
by the FFMA rate (67 TFLOP/s on an H100 SXM).

``swin_block_canvas`` / ``swin_block_fused`` launch the chain for CUDA
tensors (bf16 or f32, head dim 32) and run ``swin_block_canvas_reference``
/ ``swin_block_fused_reference`` for CPU tensors; anything else raises.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import build
from . import window_attention as wa
from .dtypes import check_kernel_dtype

LN_EPS = 1e-5
_EPI_BIAS, _EPI_GELU, _EPI_RES_GATHER, _EPI_RES_SCATTER = 0, 1, 2, 3


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


def _gemm(lib, stream, a, w_nk, bias, out, ldo, mode, res=None, ldr=0,
          rowmap=None, gates=None, gate_col=0, rows_per_sample=1):
    M, K = a.shape
    N = w_nk.shape[0]
    if (a.stride(1) != 1 or a.stride(0) % 8 or K % 8 or N % 8 or ldo % 8 or ldr % 8
            or not w_nk.is_contiguous()):
        raise ValueError("gemm kernel needs 16-byte aligned rows (K, N, strides % 8 == 0)")
    entry = lib.vgqa_gemm_f32 if a.dtype == torch.float32 else lib.vgqa_gemm_bf16
    build.check(entry(
        a.data_ptr(), a.stride(0), w_nk.data_ptr(), w_nk.stride(0),
        build.ptr(bias), out.data_ptr(), ldo, M, N, K, mode,
        build.ptr(res), ldr, build.ptr(rowmap), build.ptr(gates), gate_col,
        rows_per_sample, stream), "swin block gemm")


def _ln_rows(lib, stream, x, rowmap, scale, bias, valid, n_valid, out, M, C):
    entry = lib.vgqa_ln_rows_f32 if x.dtype == torch.float32 else lib.vgqa_ln_rows
    build.check(entry(
        x.data_ptr(), build.ptr(rowmap), scale.data_ptr(), bias.data_ptr(),
        build.ptr(valid), n_valid, out.data_ptr(), M, C, LN_EPS, stream),
        "swin block layernorm")


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

    def weight_nk(w):                     # [in, out] -> [out, in] rows
        return w.to(device=dev, dtype=dt).t().contiguous()

    wq, bq = _fold_q_scale(wqkv, bqkv, C, wa.HEAD_DIM ** -0.5)
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
    _gemm(lib, st, h, weight_nk(wq), vec(bq), qkv, 3 * C, _EPI_BIAS)
    attn = torch.empty((M, C), dtype=dt, device=dev)
    q3 = qkv.view(W, N, 3 * C)
    wa.launch(q3[..., :C], q3[..., C:2 * C], q3[..., 2 * C:],
              attn.view(W, N, C), num_heads, 1.0, bias=vec(bias), region=region)
    x1 = torch.empty((M, C), dtype=dt, device=dev)
    _gemm(lib, st, attn, weight_nk(wproj), vec(bproj), x1, C, _EPI_RES_GATHER,
          res=src, ldr=C, rowmap=read_map, gates=gates, gate_col=0,
          rows_per_sample=rows_per_sample)
    h2 = torch.empty((M, C), dtype=dt, device=dev)
    _ln_rows(lib, st, x1, None, vec(ln2_scale), vec(ln2_bias), None, 1, h2, M, C)
    f = torch.empty((M, wfc1.shape[1]), dtype=dt, device=dev)
    _gemm(lib, st, h2, weight_nk(wfc1), vec(bfc1), f, f.shape[1], _EPI_GELU)
    _gemm(lib, st, f, weight_nk(wfc2), vec(bfc2), out, C, _EPI_RES_SCATTER,
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
