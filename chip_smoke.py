"""Chip smoke test of the PyTorch/CUDA port (vgqa_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; fails at once when no CUDA device is visible.
2. Builds the hand-written kernels from vgqa_tpu_torch/csrc (one nvcc per
   source, started together) and prints the build seconds; fails when
   ptxas serialises a wgmma for lack of registers (C7511, C7512, C7520).
3. Checks each kernel against its plain PyTorch version (float32 on the same
   bf16 inputs, with TF32 off in cuBLAS and cuDNN around these checks only)
   at the shapes its path gives it, with the error relative to
   max |ref| (fails above 3e-2) and the times (CUDA events) of the kernel,
   the plain version and, where one PyTorch call computes the same function,
   that call (``library_ms``; the port never calls it):
   K2 window_attention at the encoder's serving rows (S = 124 and 418,
   key_valid: window_attn_sm90_kernel, one per call), also by device time
   (profiler) beside SDPA's and the exponential floor; K1 swin_block_canvas
   at the 12 serving block shapes (V = 2) and, with DropPath gates that
   include zeros, at the 8 training stage shapes (B = 1), each also by
   device time per phase (the wgmma GEMM of csrc/gemm_sm90.cu, the
   attention, the LayerNorms; fails unless the GEMM and the attention ran)
   beside the chain's byte floor, summed per forward with the recorded
   time of the chain it replaced (the old-vs-new line); K1'
   swin_block_fused on the windows of the rolled canvas at the 9 serving
   shapes, also held against K1 on the same canvas (the same chain with
   identity row maps); K3 flash_mha_train forward (out, lse) and backward
   (dq, dk, dv) at [512, 124, 32] and [512, 418, 32], dropout rates 0 and
   0.1 (both sides draw the same keep mask): also the forward's keep bits
   against the plain mask packed, two backward runs bit-equal, the device
   kernels per call (profiler), the exponential floor beside the bound, and
   SDPA's forward and backward timed apart at the row's dropout rate.
   Then the float32 forms at the f32 train step's shapes, against their f32
   plain versions (fails above 1e-4 of max |ref|): K1 at the 8 block shapes
   of a 64f@420 step (B = 1, gates), K1' on the same windows (and against K1),
   K2 at S = 418, K3 forward and backward at [512, 418, 32], rates 0 and 0.1
   (keep bits equal to the bf16 kernel's); CUDA-event and device times (K1
   per phase: its 3xTF32 GEMM, FFMA attention, LayerNorms), and bounds at
   the FFMA rate (67 TFLOP/s); K1's bound is that of its design, the 3xTF32
   GEMM's three tf32 products at the dense TF32 rate (494.7 TFLOP/s) plus
   its attention at the FFMA rate, with the all-FFMA bound beside it.
4. Serves the full-width default grounding model (ResNet-101, Video Swin-T,
   RoBERTa-base, 6-layer encoder, 6+6 decoders) with random weights from
   seed 0 in bf16: one warm-up request, then three pipelined 128-frame
   requests at 224 px and one at 420 px through predict_many's
   decoded-frames path, checking each response and that the K1/K2 launch
   counters rose by 12/6 per forward; then one forward with the kernel
   routes on against the same model with the plain routes.
4b. Runs the Swin-T tower alone (64 frames x 224 px, V = 2, bf16, random
   weights from seed 0) through its three block routes: canvas (K1 x 12),
   blocks (K1' x 12) and module (plain PyTorch): launch counts, tower ms,
   stage-3 error of blocks and module against canvas, peak memory.
5. Frees the serving models and trains the full-width default model with
   TPU.TRAIN_DTYPE bfloat16 at 64 frames x 224 px, V = 1, random weights
   from seed 0, on the synthetic batch: one warm-up step, three timed steps
   (ms/step by CUDA events, peak device memory), checking a finite loss,
   frozen parameters bit-unchanged, trainable ones changed, the EMA moved,
   and K1 x12, K3 forward x6 and backward x6 launches per step; the
   forward+backward and the optimizer+EMA halves timed alone; one step
   under torch.profiler (device busy share); then the loss and the global
   gradient norm of one step with the kernel routes on against the plain
   routes, from the same state with every dropout rate 0, and K3's device
   time in the profiled step. Then the same checked steps at the production
   resolution, 64 frames x 420 px (K3 at [512, 418, 32], rate 0.1), with
   three profiled steps (K3's device time, the median step; busy share).
   Then configs/grounding_vidstg.yaml as the file leaves it (TPU.TRAIN_DTYPE
   float32, 64f@420, V = 1, frozen tower, its checkpoints not loaded),
   read by the port's merge_from_file: a warm-up and two checked steps
   (K1 x12, K3 6 + 6 per step, frozen leaves unchanged, finite loss), one
   profiled step (K1 / K3 device ms; fails if a bf16 kernel ran or an f32
   one did not), and the same step with cuDNN's TF32 convolutions, a measured
   option beside the entry points' all-f32 policy. Then train_vidstg: the
   data path of ``python -m vgqa_tpu_torch.tools.train`` / ``.evaluate`` on
   configs/grounding_vidstg.yaml (float32, 64f@420, 8 loader workers) over
   a synthetic VidSTG set (4 train and 2 test videos, 640x360, 200 frames;
   frames from the renderer, the machine has no video decoder): one epoch
   of 8 synchronised steps (s/step, the loader's wait, the device's idle
   share over the 2 profiled last steps), ``test`` (do_eval, 4 items x 128
   frames in two half-passes; s/item), peak memory, K1 / K2 / K3 launches
   per step and per half-pass exact, then the evaluate tool on
   ``model_final_params`` (its metric keys are the JAX tool's). Then
   train_ddp: the same path data-parallel, each rank a spawned process that
   sets the ``VGQA_*`` contract and calls ``tools.train.main``: 2 gloo ranks
   on card 0 (4 steps at a global batch of 2, ``test`` merged; exact
   launches per rank, the ranks' parameters bit-equal, checkpoints written
   once, merged metrics equal, one dropout-free first step against one
   process's V = 2 step, 1e-4), then NCCL at min(cards, 4) ranks (world size
   1 on one card: 3 steps); s/step, the gradient all-reduce's ms and bytes
   per step, rank 0's idle share, peak GiB per rank. Then two bf16
   steps with a trainable tower (MODEL.VIDEO_SWIN.FREEZE False, the module
   route under autograd): ms/step, peak memory, finite loss, the Swin
   parameters changed, and K1 / K1' launched 0 times.
6. Checks the QA kernels against their plain versions at the shapes of the
   QA path: K4 flash_mha at [128, 1025, 64] (8 tiles x 16 heads, one ViT
   call), unmasked and with a key mask, with its device time and SDPA's
   (profiler) beside the bound and the exponential floor; K5 flash_gqa_causal at H 32 / Hkv 8
   / dh 128, Lq 1024, S 9216, length 8700, checked at q_offset 0 and 8192
   and timed at all 9 chunk offsets of a 32-frame prefill (flash_gqa_sm90_kernel,
   one per call; CUDA events and device time, SDPA's likewise, and the
   exponential floor); K6 int4_matmul
   at the four projection shapes and M = 1, 2, 64, its device time for
   one int4 decode token (224 products at M = 1) under the profiler and its
   host time per call (1,000 back-to-back calls at M = 1, 4096 x 1024).
   Then the bf16 rounding of the QA path's int8 and int4 GEMMs: int8
   quant_matmul at M = 1 and 16 (K 4096, N 4096 and 92,553) and the int4
   half-matmul form at M = 1024 (K 4096, N 14,336) against the f32 product
   of the same operands cast once; fails when more than 1% of the elements
   differ.
7. Serves video QA at the full InternVideo2.5-Chat-8B geometry
   (InternLM2.5-7B + InternViT-300M, random weights from seed 0, bf16,
   max_seq_len 9216): 32 random uint8 448 px tiles, a ~8.7k-token prompt,
   chunked prefill (9 chunks of 1024); one warm-up chat, a greedy chat of
   32 tokens (ignore_eos) on the bf16 tree, the same after int4
   quantization on the device, one sampled chat (temperature 0.2, top-p
   0.9, seeded generator) and one chat_batch of 2 on the int4 tree;
   checks answers, finite stats, the K4/K5/K6 launch counts per chat, the
   last prompt token's logits with kernel routes on against the plain
   routes for both trees (K4, K5), and one int4 decode step's logits with
   routes on against plain (K6 against the half-matmul form); prints phase
   times and peak memory.
7b. Serves the port's web app (``vgqa_tpu_torch.app.server``, in this
   process on an ephemeral port, on the card): configs/grounding_vidstg.yaml
   as the file leaves it (420 px, 2 x 64 frames, bf16, random weights from
   seed 0) and QA from a model directory holding only the InternLM2.5-7B /
   InternViT-300M geometry (bf16, random weights, the 8,192-token context
   of ``inference/qa._load_engine``). No decoder on the machine: placeholder
   video files, their frames from the synthetic renderer (``video_info``,
   ``read_frames``, ``read_frames_yuv`` and the QA tile loaders replaced).
   GET health / videos / meta; a warm-up pair per grounding policy, then 4
   concurrent /api/predict queued as pairs, pipelined (4 V = 2 forwards) and
   with VGQA_GROUND_COALESCE=1 (2 V = 4 forwards); then 12 bursts of 4 per
   policy on the server's coalescer as it runs (ABBA; the median, spread
   and latency of each) and one profiled burst each (device idle share);
   a warm-up /api/qa, 2
   concurrent /api/qa at the largest frame count whose prompt and answer
   fit the context (one chat_batch), one at 32 frames (500: the context
   error, in its own slot), one /api/generate-queries. Checks statuses,
   schemas, exact K1 / K2 / K4 / K5 launches, the coalesced responses
   against the pipelined ones (serve's limits: box 64 px, score 0.1); prints
   wall s/request per endpoint, clips/s per policy and the V = 4 peak.
8. Prints a JSON line with the kernel table, then, as the last line,
   {"ok": true, "device": {...}}.

The path phases (4-7b) run under the port's entry points' precision policy
(TF32 off in cuBLAS and cuDNN, set by ``load_model`` and the trainer). A
kernel wrapper never runs its plain version on the card: a shape its kernel
does not take raises.

Any failure raises (non-zero exit) before the last line is printed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REL_TOL = 3e-2      # bf16 kernel vs f32 plain version, relative to max |ref|
WARMUP, REPS = 2, 5
PEAK_BF16 = 989e12  # H100 SXM dense bf16 FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
PEAK_F32 = 67e12    # H100 SXM float32 FLOP/s outside the tensor cores (FFMA)
F32_TOL = 1e-4      # f32 kernel vs f32 plain version, relative to max |ref|
# H100 SXM exponentials per second: 16 per SM per clock (the SFUs) x 132 SMs
# x 1.98 GHz boost; not part of the bound (its definition counts tensor-core
# operations and bytes), printed beside it for K3
EXP_PER_S = 16 * 132 * 1.98e9


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=REPS) -> float:
    for _ in range(WARMUP):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(out, ref):
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / ref.abs().max()), float((out - ref).abs().max())


def bound(flops: float, nbytes: float, peak: float = PEAK_BF16):
    """(least ms on an H100 SXM, "operations" or "bytes"); ``peak`` the
    operations' rate for their type (PEAK_F32 for the FFMA kernels)."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


K2_NAMES = ("window_attn_sm90_kernel",)    # K2's device kernel (encoder form)


def check_window_attention(dev, g):
    """K2 at the encoder's serving rows (W 128, 8 heads of 32, key_valid) at
    S = 124 and 418: times by CUDA events and device time per call
    (profiler) for K2 and for SDPA (bool key mask) in the same process;
    beside the bound, the exponential floor (one ex2 per logit on the
    SFUs). One device kernel per call, the encoder form's."""
    from vgqa_tpu_torch.ops.kernels.window_attention import (
        window_attention, window_attention_reference)

    rows = []
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for S in (124, 418):                  # 224 px and 420 px encoder rows
        W, C, H = 128, 256, 8
        q, k, v = (torch.randn(W, S, C, generator=g, device=dev).bfloat16()
                   for _ in range(3))
        kv = (torch.rand(W, S, generator=g, device=dev) > 0.1).float()
        kv[:, 0] = 1.0
        f32 = [t.float() for t in (q, k, v)]
        out = window_attention(q, k, v, key_valid=kv, num_heads=H)
        ref = window_attention_reference(*f32, key_valid=kv, num_heads=H)
        torch.cuda.synchronize()
        rel, mae = rel_err(out, ref)
        del out, ref

        def kernel():
            return window_attention(q, k, v, key_valid=kv, num_heads=H)

        ms = cuda_ms(kernel)
        n_dev, n_k2, dev_ms = device_kernels(kernel, names=K2_NAMES,
                                             counter=lambda: window_attention.launches)[:3]
        plain = cuda_ms(lambda: window_attention_reference(*f32, key_valid=kv, num_heads=H))

        def heads(t):
            return t.reshape(W, S, H, C // H).transpose(1, 2)

        mask = (kv > 0)[:, None, None, :]

        def library():
            return sdpa(heads(q), heads(k), heads(v), attn_mask=mask)

        lib = cuda_ms(library)
        lib_dev = device_kernels(library)[3]
        b_ms, b_by = bound(4.0 * W * S * S * C, 4 * W * S * C * 2 + W * S * 4)
        exp_floor = 1e3 * W * H * S * S / EXP_PER_S
        rows.append({"S": S, "rel_err": rel, "max_abs_err": mae, "ms": ms, "device_ms": dev_ms,
                     "plain_ms": plain, "library_ms": lib, "library_device_ms": lib_dev,
                     "bound_ms": b_ms, "bound_by": b_by, "exp_floor_ms": exp_floor})
        print(f"K2 window_attention W=128 S={S} C=256 h=8: rel_err {rel:.3e} "
              f"max_abs_err {mae:.3e}  kernel {ms:.4f} ms (events), device {dev_ms:.4f} ms per "
              f"call (profiler; {n_dev:.0f} device kernels, {n_k2:.0f} K2)  plain(f32) "
              f"{plain:.3f} ms  sdpa {lib:.4f} ms (events), device {lib_dev:.4f} ms  bound "
              f"{b_ms:.4f} ms ({b_by}), exp floor {exp_floor:.4f} ms")
        if not rel < REL_TOL:
            raise AssertionError(f"window_attention S={S}: rel_err {rel} >= {REL_TOL}")
        if n_k2 != 1:
            raise AssertionError(f"window_attention S={S}: {n_k2} {K2_NAMES[0]} per call")
        del f32
    return rows


# (dims D, H, W, C, heads, shift, calls of this shape per forward at 224 px)
K1_SERVE_CASES = [
    ((64, 56, 56), 96, 3, (0, 0, 0), 1), ((64, 56, 56), 96, 3, (4, 3, 3), 1),
    ((64, 28, 28), 192, 6, (0, 0, 0), 1), ((64, 28, 28), 192, 6, (4, 3, 3), 1),
    ((64, 14, 14), 384, 12, (0, 0, 0), 3), ((64, 14, 14), 384, 12, (4, 3, 3), 3),
    ((64, 7, 7), 768, 24, (0, 0, 0), 1), ((64, 7, 7), 768, 24, (4, 3, 3), 1),
    ((64, 53, 53), 192, 6, (4, 3, 3), 0),    # 420 px stage 1: padded to 56, valid
]
K1_TRAIN_CASES = K1_SERVE_CASES[:8]


def _swin_case(dev, g, dims, C, heads, shift, batch, dtype=torch.bfloat16):
    """Random inputs (bf16, or ``dtype``) of one K1 / K1' block shape:
    (window, shift, padded dims, N, weights, canvas, bias, region, valid)."""
    from vgqa_tpu_torch.models.video_swin import (
        _adjust_window, _region_partition, _valid_partition)

    window, shift = _adjust_window(dims, (8, 7, 7), shift)
    padded = tuple(d + (-d) % w for d, w in zip(dims, window))
    N = window[0] * window[1] * window[2]

    def rnd(*s, sc=1.0):
        return (sc * torch.randn(*s, generator=g, device=dev)).to(dtype)

    ws = [1 + rnd(C, sc=0.1), rnd(C, sc=0.1), rnd(C, 3 * C, sc=C ** -0.5),
          rnd(3 * C, sc=0.1), rnd(C, C, sc=C ** -0.5), rnd(C, sc=0.1),
          1 + rnd(C, sc=0.1), rnd(C, sc=0.1), rnd(C, 4 * C, sc=C ** -0.5),
          rnd(4 * C, sc=0.1), rnd(4 * C, C, sc=(4 * C) ** -0.5), rnd(C, sc=0.1)]
    canvas = rnd(batch, *padded, C)
    bias = rnd(heads, N, N, sc=0.5)
    region = (torch.from_numpy(_region_partition(padded, window, shift)).to(dev)
              if any(shift) else None)
    valid = _valid_partition(dims, padded, window, shift)
    valid = None if valid is None else torch.from_numpy(valid).to(dev)
    return window, shift, padded, N, ws, canvas, bias, region, valid


def k1_bound(batch, padded, C, N, heads):
    """(bound ms, bound_by) of one K1 / K1' call: the four linear layers and
    the attention products; bytes: tokens in and out, weights, bias."""
    tokens = batch * padded[0] * padded[1] * padded[2]
    flops = tokens * (24.0 * C * C + 4.0 * N * C)
    nbytes = 2 * tokens * C * 2 + 12 * C * C * 2 + heads * N * N * 2
    return bound(flops, nbytes)


def k1_chain_floor(batch, padded, C, N, heads):
    """Least ms of the bf16 seven-launch chain's own bytes (not the block's
    bound): per token 26 C-wide rows through device memory (LN1 2, qkv 4,
    attention 4, proj 3, LN2 2, fc1 5, fc2 6), the weights and the bias."""
    tokens = batch * padded[0] * padded[1] * padded[2]
    return 1e3 * 2 * (26 * tokens * C + 12 * C * C + heads * N * N) / PEAK_BYTES


# K1's device kernels by phase: the GEMM (csrc/gemm_sm90.cu), the attention
# (bf16: K2's Hopper kernel in its terms form; float32: window_attn_f32_kernel)
# and the two LayerNorms
K1_PHASES = {"gemm": ("gemm_sm90_kernel",), "attn": ("window_attn_sm90_kernel",),
             "ln": ("ln_rows_kernel",)}
F32_K1_PHASES = {"gemm": ("gemm_sm90_kernel",), "attn": ("window_attn_f32_kernel",),
                 "ln": ("ln_rows_kernel",)}
# the chain before the wgmma GEMM and the terms form of the attention
# (commit 30930db: WMMA GEMM, mma.sync attention), per V = 2 forward at 224 px
# by CUDA events, and per 64f@420 f32 step, on NVIDIA H100 80GB HBM3, 700.00 W
# (PERF.md); chip_k4.py --kernel k1 / k1f32 --other measures both trees in turns
K1_RECORDED_MS = {"forward_224": 22.96, "f32_step_420": 111.5}
PEAK_TF32 = 494.7e12  # H100 SXM dense TF32 FLOP/s


def check_swin_block(dev, g, cases, batch, gated):
    from vgqa_tpu_torch.ops.kernels.swin_block import (
        swin_block_canvas, swin_block_canvas_reference)

    rows = []
    for i, (dims, C, heads, shift, per_fwd) in enumerate(cases):
        window, shift, padded, N, ws, canvas, bias, region, valid = _swin_case(
            dev, g, dims, C, heads, shift, batch)
        # DropPath gates 0 or 1/keep per branch, a dropped branch in every case
        gates = (torch.tensor([[0.0, 1.25]] if i % 2 else [[1.1111, 0.0]], device=dev)
                 .repeat(batch, 1) if gated else None)
        args = (canvas, *ws, bias, heads, window, shift)
        f32 = (canvas.float(), *[w.float() for w in ws], bias.float(), heads, window, shift)
        kw = {"region": region, "valid": valid, "gates": gates}
        out = swin_block_canvas(*args, **kw)
        ref = swin_block_canvas_reference(*f32, **kw)
        torch.cuda.synchronize()
        rel, mae = rel_err(out, ref)
        del out, ref
        ms = cuda_ms(lambda: swin_block_canvas(*args, **kw))
        ph = device_phases(lambda: swin_block_canvas(*args, **kw), K1_PHASES,
                           counter=lambda: swin_block_canvas.launches)
        plain = cuda_ms(lambda: swin_block_canvas_reference(*f32, **kw))
        b_ms, b_by = k1_bound(batch, padded, C, N, heads)
        floor = k1_chain_floor(batch, padded, C, N, heads)
        rows.append({"dims": dims, "C": C, "shift": shift, "per_fwd": per_fwd,
                     "rel_err": rel, "max_abs_err": mae, "ms": ms, "plain_ms": plain,
                     "bound_ms": b_ms, "bound_by": b_by, "chain_floor_ms": floor,
                     "device_ms": ph["all"], "gemm_device_ms": ph["gemm"],
                     "attn_device_ms": ph["attn"], "ln_device_ms": ph["ln"]})
        print(f"K1 swin_block_canvas B={batch} {dims}->{padded} C={C} h={heads} roll={shift} "
              f"valid={valid is not None} gates={gates is not None}: rel_err {rel:.3e} "
              f"max_abs_err {mae:.3e}  kernel {ms:.3f} ms (events), device {ph['all']:.3f} ms "
              f"= gemm {ph['gemm']:.3f} + attn {ph['attn']:.3f} + ln {ph['ln']:.3f}  plain(f32) "
              f"{plain:.3f} ms  bound {b_ms:.3f} ms ({b_by}), chain byte floor {floor:.3f} ms")
        if not rel < REL_TOL:
            raise AssertionError(f"swin_block_canvas {dims} C={C}: rel_err {rel} >= {REL_TOL}")
        if not (ph["gemm"] > 0 and ph["attn"] > 0):
            raise AssertionError(f"swin_block_canvas {dims}: device phases {ph}")
    return rows


def check_swin_fused(dev, g, cases, batch):
    """K1' on the windows of the rolled canvas at the K1 shapes: against its
    plain version, and window_reverse(K1'(partition(roll(canvas)))) against
    K1 on the canvas (the same chain with identity row maps: expected 0)."""
    from vgqa_tpu_torch.models.video_swin import window_partition, window_reverse
    from vgqa_tpu_torch.ops.kernels.swin_block import (
        swin_block_canvas, swin_block_fused, swin_block_fused_reference)

    rows = []
    for dims, C, heads, shift, per_fwd in cases:
        window, shift, padded, N, ws, canvas, bias, region, valid = _swin_case(
            dev, g, dims, C, heads, shift, batch)
        rolled = torch.roll(canvas, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
        windows = window_partition(rolled, window).contiguous()
        del rolled
        kw = {"region": region, "valid": valid}
        f32 = (windows.float(), *[w.float() for w in ws], bias.float(), heads)
        out = swin_block_fused(windows, *ws, bias, heads, **kw)
        ref = swin_block_fused_reference(*f32, **kw)
        k1 = swin_block_canvas(canvas, *ws, bias, heads, window, shift, **kw)
        torch.cuda.synchronize()
        rel, mae = rel_err(out, ref)
        k1_rel, k1_mae = rel_err(window_reverse(out, window, batch, *padded), k1)
        del out, ref, k1
        ms = cuda_ms(lambda: swin_block_fused(windows, *ws, bias, heads, **kw))
        plain = cuda_ms(lambda: swin_block_fused_reference(*f32, **kw))
        b_ms, b_by = k1_bound(batch, padded, C, N, heads)
        rows.append({"dims": dims, "C": C, "shift": shift, "per_fwd": per_fwd,
                     "rel_err": rel, "max_abs_err": mae, "vs_k1_max_abs": k1_mae,
                     "ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by})
        print(f"K1' swin_block_fused W={windows.shape[0]} N={N} C={C} h={heads} "
              f"({dims}->{padded}, roll {shift}, valid={valid is not None}): rel_err {rel:.3e} "
              f"max_abs_err {mae:.3e}  vs K1 on the canvas: max abs diff {k1_mae:.3e}  "
              f"kernel {ms:.3f} ms  plain(f32) {plain:.3f} ms  bound {b_ms:.3f} ms ({b_by})")
        if not (rel < REL_TOL and k1_rel < REL_TOL):
            raise AssertionError(f"swin_block_fused {dims} C={C}: rel_err {rel}, vs K1 "
                                 f"{k1_rel} (limit {REL_TOL})")
        del windows, f32
    torch.cuda.empty_cache()
    return rows


K3_NAMES = ("attn_fwd_kernel<32", "flash_bwd_kernel")   # K3's forward and backward


# every profiler window that was taken again, with the evidence that showed
# it short; printed together at the end of the run
RETAKEN = []


def device_kernels(fn, calls=10, names=K3_NAMES, counter=None):
    """Under the profiler, ``calls`` calls of ``fn``: (device kernels per
    call, kernels per call whose name contains one of ``names`` (K3's by
    default), their device ms per call, device ms of all kernels per
    call).

    The card machine's profiler has reported fewer device kernels than
    were launched. So each window is also timed by CUDA events and, with
    ``counter`` (a function that reads the wrapper's launch count), the
    wrapper's launches in it are read. A window whose named kernels fall
    short of those launches, or whose event count is not a whole multiple
    of the calls, goes into ``RETAKEN`` with that evidence and is taken
    again, up to five windows in all. The first whole window is kept (the
    window after an empty one has held more kernels than its calls
    launch), else the fullest. A kernel launched more
    than once per call still shows as such."""
    events = _profiled_events(fn, calls, names, counter)
    k3 = [e for e in events if any(k in e.name for k in names)]

    def ms(es):
        return sum(e.time_range.end - e.time_range.start for e in es) / calls / 1e3

    return len(events) / calls, len(k3) / calls, ms(k3), ms(events)


def device_phases(fn, phases, calls=3, counter=None):
    """Device ms per call of each phase of ``fn`` ({phase: name substrings}),
    and of all its kernels (key "all"), from one profiler window (taken
    again when short, as in :func:`device_kernels`)."""
    names = tuple(k for ks in phases.values() for k in ks)
    events = _profiled_events(fn, calls, names, counter)
    out = {p: sum(e.time_range.end - e.time_range.start for e in events
                  if any(k in e.name for k in ks)) / calls / 1e3 for p, ks in phases.items()}
    out["all"] = sum(e.time_range.end - e.time_range.start for e in events) / calls / 1e3
    return out


def _profiled_events(fn, calls, names, counter):
    """The device events of a whole profiler window of ``calls`` calls (see
    :func:`device_kernels`)."""
    from torch.profiler import ProfilerActivity, profile

    events = []
    for attempt in range(5):
        torch.cuda.synchronize()
        before = counter() if counter else None
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start.record()
            for _ in range(calls):
                fn()
            end.record()
            torch.cuda.synchronize()
        launched = counter() - before if counter else None
        got = [e for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
        named = sum(any(k in e.name for k in names) for e in got)
        short = (not got or len(got) % calls != 0
                 or (launched is not None and named < launched))
        if short:
            RETAKEN.append(
                f"window {attempt + 1} of {fn.__qualname__}: profiler {len(got)} device "
                f"kernels, {named} named {names[0]}.., for {calls} calls; wrapper launches "
                f"{launched}; CUDA events {start.elapsed_time(end):.4f} ms over the window")
            print("profiler window short: " + RETAKEN[-1], flush=True)
        if not short:
            events = got
            break
        if len(got) > len(events):
            events = got
    return events


def check_flash_train(dev, g):
    from vgqa_tpu_torch.ops.kernels.flash_train import (
        flash_mha_train, flash_train_bwd, flash_train_bwd_reference, flash_train_fwd,
        flash_train_fwd_reference, fold_heads, keep_mask, pack_keep_bits)

    rows = []
    W, H, D = 64, 8, 32                    # 64 frames x 8 heads = 512 rows, dh 32
    scale = D ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for L in (124, 418):                   # 224 px and 420 px encoder rows
        q, k, v, do = (torch.randn(W, L, H * D, generator=g, device=dev).bfloat16()
                       for _ in range(4))
        mask = torch.rand(W, L, generator=g, device=dev) > 0.1
        mask[:, 0] = True
        f32 = [fold_heads(t.float(), H) for t in (q, k, v, do)]
        maskf = mask.repeat_interleave(H, dim=0)
        for rate in (0.0, 0.1):
            args = (mask, 12345, rate, scale, H)
            out, lse, bits = flash_train_fwd(q, k, v, *args)
            bwd_args = (q, k, v, out, do, lse, bits, mask, rate, scale, H)
            grads = flash_train_bwd(*bwd_args)
            again = flash_train_bwd(*bwd_args)
            r_out, r_lse = flash_train_fwd_reference(*f32[:3], maskf, 12345, rate, scale)
            r_grads = flash_train_bwd_reference(*f32[:3], r_out, f32[3], r_lse, maskf, 12345,
                                                rate, scale)
            errs = {"out": rel_err(fold_heads(out, H), r_out)}
            errs.update({n: rel_err(fold_heads(a, H), b)
                         for n, a, b in zip(("dq", "dk", "dv"), grads, r_grads)})
            lse_err = float((lse - r_lse).abs().max())
            bit_equal = all(torch.equal(a, b) for a, b in zip(grads, again))
            bits_equal = None
            if rate > 0:
                bits_equal = bool(torch.equal(bits, pack_keep_bits(
                    keep_mask(12345, W * H, L, L, rate, dev))))
            del grads, again, r_grads, r_out, r_lse
            fwd_n, fwd_k3, fwd_dev, _ = device_kernels(
                lambda: flash_train_fwd(q, k, v, *args),
                counter=lambda: flash_mha_train.fwd_launches)
            bwd_n, bwd_k3, bwd_dev, _ = device_kernels(
                lambda: flash_train_bwd(*bwd_args), counter=lambda: flash_mha_train.bwd_launches)
            launches = {"fwd": (fwd_n, fwd_k3), "bwd": (bwd_n, bwd_k3)}
            fwd_ms = cuda_ms(lambda: flash_train_fwd(q, k, v, *args))
            bwd_ms = cuda_ms(lambda: flash_train_bwd(*bwd_args))

            def plain():
                o, s = flash_train_fwd_reference(*f32[:3], maskf, 12345, rate, scale)
                flash_train_bwd_reference(*f32[:3], o, f32[3], s, maskf, 12345,
                                          rate, scale)

            plain_ms = cuda_ms(plain)
            # SDPA (bool key mask), the port never calls it: library_ms is its
            # forward+backward by CUDA events at rate 0; library_{fwd,bwd}_device_ms
            # its forward and backward apart by device time at this row's rate
            # (at 0.1 its own dropout)
            qh, kh, vh = (t.reshape(W, L, H, D).transpose(1, 2).detach().requires_grad_()
                          for t in (q, k, v))
            doh = do.reshape(W, L, H, D).transpose(1, 2)
            am = mask[:, None, None, :]
            lib_ms = None
            if rate == 0.0:
                def library():
                    o = sdpa(qh, kh, vh, attn_mask=am)
                    torch.autograd.grad(o, (qh, kh, vh), doh)

                lib_ms = cuda_ms(library)
            lib_fwd_dev = device_kernels(lambda: sdpa(qh, kh, vh, attn_mask=am,
                                                      dropout_p=rate))[3]
            o_lib = sdpa(qh, kh, vh, attn_mask=am, dropout_p=rate)
            lib_bwd_dev = device_kernels(lambda: torch.autograd.grad(
                o_lib, (qh, kh, vh), doh, retain_graph=True))[3]
            del o_lib, qh, kh, vh
            B = W * H
            elems = B * L * D
            f_ms, f_by = bound(4.0 * B * L * L * D, 4 * elems * 2 + B * L * 4 + W * L)
            b_ms, b_by = bound(10.0 * B * L * L * D, 8 * elems * 2 + B * L * 4 + W * L)
            row = {"L": L, "rate": rate, "max_rel_err": max(e[0] for e in errs.values()),
                   "max_abs_err": max(e[1] for e in errs.values()), "lse_abs_err": lse_err,
                   "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_device_ms": fwd_dev,
                   "bwd_device_ms": bwd_dev, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "library_fwd_device_ms": lib_fwd_dev, "library_bwd_device_ms": lib_bwd_dev,
                   "fwd_bound_ms": f_ms, "bwd_bound_ms": b_ms,
                   "exp_floor_ms": 1e3 * B * L * L / EXP_PER_S,
                   "bound_by": "bytes" if "bytes" in (f_by, b_by) else "operations",
                   "launches_per_call": launches, "bwd_bit_equal": bit_equal,
                   "keep_bits_equal": bits_equal}
            rows.append(row)
            print(f"K3 flash_mha_train [512, {L}, 32] rate={rate}: rel_err "
                  + " ".join(f"{n} {e[0]:.3e}" for n, e in errs.items())
                  + f"  lse abs {lse_err:.2e}  fwd {fwd_ms:.4f} ms  bwd {bwd_ms:.4f} ms (CUDA "
                  f"events over back-to-back calls; device {fwd_dev:.4f} + {bwd_dev:.4f} ms "
                  f"per call, profiler)  plain(f32) fwd+bwd {plain_ms:.3f} ms  sdpa fwd+bwd "
                  + ("-" if lib_ms is None else f"{lib_ms:.3f} ms")
                  + f" (events), device fwd {lib_fwd_dev:.4f} + bwd {lib_bwd_dev:.4f} ms at "
                  f"dropout_p={rate}  bound fwd {f_ms:.4f} ({f_by}) bwd "
                  f"{b_ms:.4f} ms ({b_by}), exp floor {row['exp_floor_ms']:.4f} ms per pass; "
                  f"device kernels per call (all, K3) fwd {launches['fwd']} bwd "
                  f"{launches['bwd']}; bwd bit-equal {bit_equal}; keep bits = plain mask "
                  f"packed: {bits_equal}")
            if not (row["max_rel_err"] < REL_TOL and lse_err < 1e-2):
                raise AssertionError(f"flash_mha_train L={L} rate={rate}: {errs}, lse {lse_err}")
            if not bit_equal or bits_equal is False:
                raise AssertionError(f"flash_mha_train L={L} rate={rate}: backward bit-equal "
                                     f"{bit_equal}, keep bits equal {bits_equal}")
            if launches["fwd"][1] != 1 or launches["bwd"][1] != 1:
                raise AssertionError(f"flash_mha_train L={L} rate={rate}: K3 kernels per "
                                     f"call {launches}, expected one forward and one backward")
            del out, lse, bits
        del q, k, v, do, f32
        torch.cuda.empty_cache()
    return rows


K4_NAMES = ("flash_mha_sm90_kernel",)      # K4's device kernel (both variants)


def check_flash_mha(dev, g):
    """K4 at one InternViT call: 8 tiles x 16 heads, L = 1025, dh = 64, q/k/v
    as slices of the fused qkv projection; maskless and masked. Times: CUDA
    events over back-to-back calls, and device time per call (profiler) for
    K4 and for SDPA in the same process; beside the bound, the exponential
    floor (one ex2 per logit on the SFUs)."""
    from vgqa_tpu_torch.ops.kernels.flash_attention import flash_mha, flash_mha_reference

    rows = []
    T, L, H, D = 8, 1025, 16, 64
    qkv = torch.randn(T, L, 3 * H * D, generator=g, device=dev).bfloat16()
    q, k, v = qkv.split(H * D, dim=-1)
    f32 = [t.float() for t in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for masked in (False, True):
        mask = None
        if masked:
            mask = torch.rand(T, L, generator=g, device=dev) > 0.2
            mask[:, 0] = True
        out = flash_mha(q, k, v, H, key_mask=mask)
        ref = flash_mha_reference(*f32, H, key_mask=mask)
        torch.cuda.synchronize()
        rel, mae = rel_err(out, ref)
        del out, ref
        ms = cuda_ms(lambda: flash_mha(q, k, v, H, key_mask=mask))
        plain = cuda_ms(lambda: flash_mha_reference(*f32, H, key_mask=mask))
        n_dev, n_k4, dev_ms = device_kernels(lambda: flash_mha(q, k, v, H, key_mask=mask),
                                             names=K4_NAMES,
                                             counter=lambda: flash_mha.launches)[:3]

        def heads(t):
            return t.reshape(T, L, H, D).transpose(1, 2)

        am = None if mask is None else mask[:, None, None, :]

        def library():
            return sdpa(heads(q), heads(k), heads(v), attn_mask=am)

        lib = cuda_ms(library)
        lib_dev = device_kernels(library)[3]
        b_ms, b_by = bound(4.0 * T * H * L * L * D, 4 * T * L * H * D * 2 + T * L * int(masked))
        exp_floor = 1e3 * T * H * L * L / EXP_PER_S
        rows.append({"masked": masked, "rel_err": rel, "max_abs_err": mae, "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain, "library_ms": lib,
                     "library_device_ms": lib_dev, "bound_ms": b_ms, "bound_by": b_by,
                     "exp_floor_ms": exp_floor, "kernels_per_call": (n_dev, n_k4)})
        print(f"K4 flash_mha [128, 1025, 64] masked={masked}: rel_err {rel:.3e} max_abs_err "
              f"{mae:.3e}  kernel {ms:.4f} ms (events), device {dev_ms:.4f} ms per call "
              f"(profiler; {n_dev:.0f} device kernels, {n_k4:.0f} K4)  plain(f32) {plain:.3f} ms"
              f"  sdpa {lib:.4f} ms (events), device {lib_dev:.4f} ms  bound {b_ms:.4f} ms "
              f"({b_by}), exp floor {exp_floor:.4f} ms")
        if not rel < REL_TOL:
            raise AssertionError(f"flash_mha masked={masked}: rel_err {rel} >= {REL_TOL}")
        if n_k4 != 1:
            raise AssertionError(f"flash_mha masked={masked}: {n_k4} K4 kernels per call")
    return rows


QA_CHUNKS = 9                # 32-frame prefill: Lp = 9216 in chunks of 1024


K5_NAMES = ("flash_gqa_sm90_kernel",)      # K5's device kernel


def check_flash_gqa(dev, g):
    """K5 at the 32-frame prefill: H 32, Hkv 8, dh 128, Lq 1024, S 9216,
    length 8700; checked at q_offset 0 and 8192, timed at all 9 offsets by
    CUDA events and by device time (profiler), SDPA (``enable_gqa``, bool
    mask) likewise in the same process; beside the bound, the exponential
    floor (one ex2 per visible logit). One device kernel per call, K5's."""
    from vgqa_tpu_torch.ops.kernels.flash_attention import (
        flash_gqa_causal, flash_gqa_causal_reference)

    H, Hkv, Lq, S, D, length = 32, 8, 1024, 9216, 128, 8700
    q = torch.randn(Lq, H, D, generator=g, device=dev).bfloat16().transpose(0, 1)
    k, v = (torch.randn(Hkv, S, D, generator=g, device=dev).bfloat16() for _ in range(2))
    n = torch.tensor(length, device=dev)
    f32 = [t.float() for t in (q, k, v)]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for i in range(QA_CHUNKS):
        off = i * Lq
        rel = mae = None
        if off in (0, 8192):
            out = flash_gqa_causal(q, k, v, off, n)
            ref = flash_gqa_causal_reference(*f32, off, n)
            torch.cuda.synchronize()
            rel, mae = rel_err(out, ref)
            del out, ref
            if not rel < REL_TOL:
                raise AssertionError(f"flash_gqa_causal q_offset={off}: rel_err {rel} >= {REL_TOL}")

        def kernel():
            return flash_gqa_causal(q, k, v, off, n)

        ms = cuda_ms(kernel)
        n_dev, n_k5, dev_ms = device_kernels(kernel, names=K5_NAMES,
                                             counter=lambda: flash_gqa_causal.launches)[:3]
        plain = cuda_ms(lambda: flash_gqa_causal_reference(*f32, off, n), reps=2)
        qpos = off + torch.arange(Lq, device=dev)
        kpos = torch.arange(S, device=dev)
        am = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < length)

        def library():
            return sdpa(q[None], k[None], v[None], attn_mask=am, enable_gqa=True)

        lib = cuda_ms(library)
        lib_dev = device_kernels(library)[3]
        # operations over the keys this chunk's queries may see; bytes: q,
        # out, and the K/V rows up to the causal frontier (and length)
        valid = sum(min(off + r + 1, length) for r in range(Lq))
        kread = min(off + Lq, length, S)
        b_ms, b_by = bound(4.0 * H * D * valid, 2 * H * Lq * D * 2 + 2 * Hkv * kread * D * 2)
        exp_floor = 1e3 * H * valid / EXP_PER_S
        rows.append({"q_offset": off, "rel_err": rel, "max_abs_err": mae, "ms": ms,
                     "device_ms": dev_ms, "plain_ms": plain, "library_ms": lib,
                     "library_device_ms": lib_dev, "bound_ms": b_ms, "bound_by": b_by,
                     "exp_floor_ms": exp_floor})
        print(f"K5 flash_gqa_causal H32/Hkv8/dh128 Lq 1024 S 9216 len {length} q_offset {off}: "
              + ("" if rel is None else f"rel_err {rel:.3e} max_abs_err {mae:.3e}  ")
              + f"kernel {ms:.4f} ms (events), device {dev_ms:.4f} ms (profiler; {n_dev:.0f} "
              f"device kernels, {n_k5:.0f} K5)  plain(f32) {plain:.3f} ms  sdpa {lib:.4f} ms "
              f"(events), device {lib_dev:.4f} ms  bound {b_ms:.4f} ms ({b_by}), exp floor "
              f"{exp_floor:.4f} ms")
        if n_k5 != 1:
            raise AssertionError(f"flash_gqa_causal q_offset={off}: {n_k5} {K5_NAMES[0]} per call")
    print(f"K5 per 32-frame prefill (32 layers x the 9 chunks): device "
          f"{32 * sum(r['device_ms'] for r in rows):.2f} ms, events "
          f"{32 * sum(r['ms'] for r in rows):.2f} ms; SDPA device "
          f"{32 * sum(r['library_device_ms'] for r in rows):.2f} ms; bound "
          f"{32 * sum(r['bound_ms'] for r in rows):.2f} ms, exp floor "
          f"{32 * sum(r['exp_floor_ms'] for r in rows):.2f} ms")
    del f32
    torch.cuda.empty_cache()
    return rows


# (K, N, name) of the seven projections of one InternLM2.5-7B layer
QA_PROJ = [(4096, 4096, "q"), (4096, 1024, "k"), (4096, 1024, "v"), (4096, 4096, "o"),
           (4096, 14336, "gate"), (4096, 14336, "up"), (14336, 4096, "down")]


def int4_library(x, packed, scale):
    """One PyTorch call computing the same product, if this torch has one:
    ``_weight_int4pack_mm`` on a repacked copy (unsigned nibbles with
    offset 8, bf16 scales, zero points 0); otherwise None."""
    K, N = x.shape[1], packed.shape[1]
    half = K // 2
    n_g = scale.shape[0]
    try:
        lo, hi = (packed << 4) >> 4, packed >> 4
        q = torch.cat([lo, hi], 0).to(torch.int32).t() + 8                # [N, K] in 0..15
        u8 = ((q[:, ::2] << 4) | q[:, 1::2]).to(torch.uint8).contiguous()  # [N, K/2]
        w = torch._convert_weight_to_int4pack(u8, 8)
        sz = torch.stack([scale, torch.zeros_like(scale)], -1).bfloat16().contiguous()
        fn = (lambda: torch._weight_int4pack_mm(x, w, K // n_g, sz))
        fn()
        return fn
    except (RuntimeError, AttributeError, TypeError) as e:
        print(f"  int4 library call unavailable ({type(e).__name__}: {str(e)[:120]}); "
              "timing torch.matmul on the dequantized bf16 weight instead")
        return None


def check_int4(dev, g):
    """K6 at the seven projection shapes (four distinct) and M = 1, 2, 64."""
    from vgqa_tpu_torch.ops.kernels.int4_matmul import (
        int4_matmul, int4_matmul_kernel_applicable, int4_matmul_reference)
    from vgqa_tpu_torch.qa.quant import dequantize_kernel_int4

    rows = []
    for K, N in sorted({(k, n) for k, n, _ in QA_PROJ}):
        n_g = K // 128
        packed = torch.randint(-128, 128, (K // 2, N), generator=g, device=dev,
                               dtype=torch.int32).to(torch.int8)
        scale = torch.rand(n_g, N, generator=g, device=dev) * 0.01
        w_bf16 = dequantize_kernel_int4({"kernel_q4": packed, "scale4": scale}, torch.bfloat16)
        for M in (1, 2, 64):
            assert int4_matmul_kernel_applicable(M, K, N, n_g)
            x = torch.randn(M, K, generator=g, device=dev).bfloat16()
            out = int4_matmul(x, packed, scale)
            ref = int4_matmul_reference(x, packed, scale)
            torch.cuda.synchronize()
            rel, mae = rel_err(out, ref)
            if not rel < REL_TOL:
                raise AssertionError(f"int4_matmul {M}x{K}x{N}: rel_err {rel} >= {REL_TOL}")
            ms = cuda_ms(lambda: int4_matmul(x, packed, scale))
            plain = cuda_ms(lambda: int4_matmul_reference(x, packed, scale))
            lib_fn = int4_library(x, packed, scale)
            lib_name = "_weight_int4pack_mm"
            if lib_fn is not None:
                lrel = rel_err(lib_fn(), ref)[0]
                if not lrel < REL_TOL:
                    print(f"  _weight_int4pack_mm disagrees (rel {lrel:.2e}): not this "
                          "function; timing torch.matmul on the dequantized bf16 weight")
                    lib_fn = None
            if lib_fn is None:
                lib_name = "matmul_dequantized_bf16"
                lib_fn = (lambda: torch.matmul(x, w_bf16))
            lib = cuda_ms(lib_fn)
            b_ms, b_by = bound(2.0 * M * K * N, K * N // 2 + n_g * N * 4 + M * K * 2 + M * N * 2)
            rows.append({"M": M, "K": K, "N": N, "rel_err": rel, "max_abs_err": mae, "ms": ms,
                         "plain_ms": plain, "library_ms": lib, "library": lib_name,
                         "bound_ms": b_ms, "bound_by": b_by})
            print(f"K6 int4_matmul M={M} K={K} N={N}: rel_err {rel:.3e} max_abs_err {mae:.3e}  "
                  f"kernel {ms:.4f} ms  plain {plain:.3f} ms  {lib_name} {lib:.4f} ms  "
                  f"bound {b_ms:.4f} ms ({b_by})")
        del packed, scale, w_bf16
    torch.cuda.empty_cache()
    return rows


def int4_host_us(dev, g, calls=1000):
    """K6's host time per call: the wall time of ``calls`` back-to-back
    launches at M = 1, 4096 x 1024 (the device keeps up), over ``calls``;
    then a synchronize."""
    from vgqa_tpu_torch.ops.kernels.int4_matmul import int4_matmul

    K, N = 4096, 1024
    packed = torch.randint(-128, 128, (K // 2, N), generator=g, device=dev,
                           dtype=torch.int32).to(torch.int8)
    scale = torch.rand(K // 128, N, generator=g, device=dev) * 0.01
    x = torch.randn(1, K, generator=g, device=dev).bfloat16()
    for _ in range(20):
        int4_matmul(x, packed, scale)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        int4_matmul(x, packed, scale)
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    print(f"K6 host time per call (M = 1, {K}x{N}, {calls} back-to-back calls): {us:.2f} us")
    return us


def check_quant_bf16(dev, g):
    """The int8 and int4 GEMMs of the QA path round to bf16 once: each
    product against the f32 product of the same bf16 operands, scaled, cast
    once (the JAX form, ``preferred_element_type=float32``). Fails when
    more than 1% of the elements differ (a product rounded to bf16 before
    its scale or before the halves are added differs in ~26-37%)."""
    from vgqa_tpu_torch.qa.quant import (matmul_f32, quant_matmul, quant_matmul_int4,
                                         quantize_kernel, quantize_kernel_int4)
    from vgqa_tpu_torch.ops.kernels.int4_matmul import int4_matmul_kernel_applicable

    rows = []

    def report(name, got, want):
        frac = float((got != want).float().mean())
        rel = rel_err(got, want)[0]
        print(f"bf16 rounding {name}: {100 * frac:.4f}% of elements differ from the "
              f"once-rounded f32 product (rel err {rel:.2e})")
        if not frac <= 0.01:
            raise AssertionError(f"{name}: {100 * frac:.2f}% of elements differ (> 1%)")
        rows.append({"name": name, "frac_differ": frac, "rel_err": rel})

    K = 4096
    for N in (4096, 92553):
        qp = quantize_kernel(torch.randn(K, N, generator=g, device=dev) * 0.05)
        for M in (1, 16):
            x = torch.randn(M, K, generator=g, device=dev).bfloat16()
            want = (x.float() @ qp["kernel_q"].float()).mul(qp["scale"]).bfloat16()
            report(f"int8 quant_matmul M={M} K={K} N={N}", quant_matmul(x, qp), want)
        del qp
    M, N = 1024, 14336
    qp = quantize_kernel_int4(torch.randn(K, N, generator=g, device=dev) * 0.05)
    assert not int4_matmul_kernel_applicable(M, K, N, K // 128)
    x = torch.randn(M, K, generator=g, device=dev).bfloat16()
    lo, hi = (qp["kernel_q4"] << 4) >> 4, qp["kernel_q4"] >> 4
    n2 = qp["scale4"].shape[0] // 2
    want = 0.0
    for q, s, xs in ((lo, qp["scale4"][:n2], x[:, :K // 2]), (hi, qp["scale4"][n2:], x[:, K // 2:])):
        w = (q.bfloat16().reshape(n2, 128, N) * s[:, None, :].bfloat16()).reshape(K // 2, N)
        want = want + xs.float() @ w.float()
    report(f"int4 half form M={M} K={K} N={N}", quant_matmul_int4(x, qp), want.bfloat16())
    y = matmul_f32(x[:, :K // 2], lo.bfloat16())      # aten::mm.dtype on the card
    if y.dtype != torch.float32:
        raise AssertionError(f"matmul_f32 returned {y.dtype}")
    del qp, lo, hi, x, want, y
    torch.cuda.empty_cache()
    return rows


def int4_token_device_ms(dev, g, layers=32):
    """K6's device time for one int4 decode token: the seven projections of
    each layer at M = 1, ``layers`` times, under torch.profiler (the CUDA
    event times above include the host's launch cost)."""
    from vgqa_tpu_torch.ops.kernels.int4_matmul import int4_matmul

    ws = []
    for K, N, _ in QA_PROJ:
        packed = torch.randint(-128, 128, (K // 2, N), generator=g, device=dev,
                               dtype=torch.int32).to(torch.int8)
        ws.append((torch.randn(1, K, generator=g, device=dev).bfloat16(), packed,
                   torch.rand(K // 128, N, generator=g, device=dev) * 0.01))

    def token():
        for _ in range(layers):
            for x, packed, scale in ws:
                int4_matmul(x, packed, scale)

    token()
    wall, busy, n, top = profile_step(token)
    k6 = sum(us for name, us in top if "int4_matmul" in name) / 1e3
    print(f"K6 one int4 decode token ({layers} x 7 products at M = 1) under the profiler: "
          f"device {k6:.3f} ms in {n} launches, wall {wall:.2f} ms")
    return k6


def full_cfg(res: int, **overrides):
    from vgqa_tpu_torch.config import build_default_cfg

    cfg = build_default_cfg()
    cfg.INPUT.RESOLUTION = res
    for key, value in overrides.items():
        node = cfg
        *path, leaf = key.split(".")
        for p in path:
            node = node[p]
        node[leaf] = value
    cfg.freeze()
    return cfg


def check_response(out, n_frames: int):
    t = out["temporal"]
    if not 0.0 <= t["start"] <= t["end"]:
        raise AssertionError(f"span out of order: {t}")
    if len(out["tube"]) != n_frames:
        raise AssertionError(f"{len(out['tube'])} tube entries for {n_frames} frames")
    boxes = np.asarray([e["bbox"] for e in out["tube"]])
    scores = np.asarray([e["score"] for e in out["tube"]])
    if not (np.isfinite(boxes).all() and np.isfinite(scores).all()):
        raise AssertionError("non-finite boxes or scores")
    if not ((boxes[:, 0] <= boxes[:, 2]).all() and (boxes[:, 1] <= boxes[:, 3]).all()):
        raise AssertionError("boxes are not x0<=x1, y0<=y1")


def make_requests(n, res, seed, t2=128):
    rng = np.random.RandomState(seed)
    return [{"frames": rng.randint(0, 256, (t2, res, res, 3), np.uint8), "fps": 25.0,
             "ori_size": (360, 640), "query": f"the person in red walks to the car {i}"}
            for i in range(n)]


def set_kernel_routes(model, on: bool):
    model.vid.use_kernels = on
    for i in range(model.cfg.enc_layers):
        getattr(model.ground_encoder, f"layer_{i}").self_attn.use_flash = on


def _counted():
    from vgqa_tpu_torch.ops.kernels.flash_attention import flash_gqa_causal, flash_mha
    from vgqa_tpu_torch.ops.kernels.flash_train import flash_mha_train
    from vgqa_tpu_torch.ops.kernels.int4_matmul import int4_matmul
    from vgqa_tpu_torch.ops.kernels.swin_block import swin_block_canvas, swin_block_fused
    from vgqa_tpu_torch.ops.kernels.window_attention import window_attention

    return {"swin_block_canvas": (swin_block_canvas, "launches"),
            "swin_block_fused": (swin_block_fused, "launches"),
            "window_attention": (window_attention, "launches"),
            "flash_mha_train.fwd": (flash_mha_train, "fwd_launches"),
            "flash_mha_train.bwd": (flash_mha_train, "bwd_launches"),
            "flash_mha": (flash_mha, "launches"),
            "flash_gqa_causal": (flash_gqa_causal, "launches"),
            "int4_matmul": (int4_matmul, "launches")}


def reset_launches():
    for fn, attr in _counted().values():
        setattr(fn, attr, 0)


def read_launches():
    return {name: getattr(fn, attr) for name, (fn, attr) in _counted().items()}


@contextlib.contextmanager
def all_f32():
    """TF32 off in cuBLAS and cuDNN around a kernel-versus-plain check, so
    the float32 plain versions stay float32; the flags as they were after.
    The path phases run what the port's entry points set
    (``utils/device.apply_precision_policy``)."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def serve(dev, card):
    from vgqa_tpu_torch.inference.grounding import (
        _group_inputs, _prepare, load_model, predict_many)
    from vgqa_tpu_torch.training.evaluator import dispatch_forward

    t0 = time.perf_counter()
    loaded = load_model(full_cfg(224), device=dev, seed=0)
    loaded_420 = load_model(full_cfg(420), device=dev, seed=0)
    print(f"models built in {time.perf_counter() - t0:.1f} s "
          f"(dtype {loaded.dtype}, {sum(p.numel() for p in loaded.model.parameters())/1e6:.1f}M params)")

    t0 = time.perf_counter()
    warm = predict_many(make_requests(1, 224, seed=1), loaded=loaded)
    if isinstance(warm[0], Exception):
        raise warm[0]
    torch.cuda.synchronize()
    print(f"warm-up request (224 px): {time.perf_counter() - t0:.3f} s")

    reqs = make_requests(3, 224, seed=2)
    reqs420 = make_requests(1, 420, seed=3)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    outs = predict_many(reqs, loaded=loaded)
    t224 = time.perf_counter() - t0
    t0 = time.perf_counter()
    outs += predict_many(reqs420, loaded=loaded_420)
    t420 = time.perf_counter() - t0
    launches = read_launches()
    for out in outs:
        if isinstance(out, Exception):
            raise out
        check_response(out, 128)
    forwards = len(outs)
    print(f"served 3 requests x 128 frames @224 px (pipelined predict_many): "
          f"{t224:.3f} s total, {t224 / 3:.3f} s/request, {3 * 2 / t224:.2f} clips/s "
          f"(clip = one 64-frame half)  [{card}]")
    print(f"served 1 request x 128 frames @420 px (first call at this size): "
          f"{t420:.3f} s/request, {2 / t420:.2f} clips/s  [{card}]")
    print(f"launches over {forwards} forwards: {launches}")
    if launches != {"swin_block_canvas": 12 * forwards, "swin_block_fused": 0,
                    "window_attention": 6 * forwards, "flash_mha_train.fwd": 0, "flash_mha_train.bwd": 0,
                    "flash_mha": 0, "flash_gqa_causal": 0, "int4_matmul": 0}:
        raise AssertionError(f"expected 12 and 6 launches per forward, got {launches}")
    print("response 0:", json.dumps({"temporal": outs[0]["temporal"],
                                     "tube[0]": outs[0]["tube"][0]}))

    # ---- kernel routes vs plain routes on one full-width forward ----------
    job = _prepare(loaded, make_requests(1, 224, seed=4)[0])
    fwd, video, text, infos, _, canvas = _group_inputs(loaded, [job])
    results = {}
    for on in (True, False):
        set_kernel_routes(loaded.model, on)
        packed, span = dispatch_forward(fwd, video, text, infos, canvas=canvas)
        results[on] = (packed.float().cpu(), span.cpu())
    set_kernel_routes(loaded.model, True)
    box_diff = float((results[True][0][..., :4] - results[False][0][..., :4]).abs().max())
    att_diff = float((results[True][0][..., 4] - results[False][0][..., 4]).abs().max())
    print(f"kernel vs plain routes, full forward @224 px: max |d box| {box_diff:.3f} px "
          f"(of 640x360), max |d att| {att_diff:.4f}, spans {results[True][1].tolist()} vs "
          f"{results[False][1].tolist()}")
    # random weights, bf16: 40-odd layers amplify rounding differences between
    # the kernel and plain routes (2.5 px / 0.008 measured on the H100); the
    # limits sit an order of magnitude above that and far below a broken
    # kernel, which moves boxes by hundreds of pixels or turns them non-finite
    if not (np.isfinite(box_diff) and att_diff < 0.1 and box_diff < 64.0):
        raise AssertionError("kernel and plain routes disagree on the full forward")
    return launches


def timed(fn, reps=3):
    """(device ms, host ms) per call of ``fn``: CUDA events around ``reps``
    calls, and the host clock to the end of the last call's enqueue."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        fn()
    host = 1e3 * (time.perf_counter() - t0) / reps
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, host


def profile_step(step):
    """Run ``step()`` once under torch.profiler (again, up to three times in
    all, when the window held no device event: it goes into ``RETAKEN``
    beside the wrappers' launches in it); returns (wall ms, device busy ms
    as the union of kernel intervals, kernel launches, (name, device us) of
    every kernel name by time)."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):
        before = sum(read_launches().values())
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
        if spans:
            break
        RETAKEN.append(f"profiled step, window {attempt + 1}: no device event; wrapper "
                       f"launches {sum(read_launches().values()) - before}; wall {wall:.1f} ms")
        print("profiler window short: " + RETAKEN[-1], flush=True)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = {}
    for e in prof.events():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])
    return wall, busy / 1e3, len(spans), top


def train_steps(dev, card, res: int, cfg=None, steps: int = 3):
    """The full-width default model with TPU.TRAIN_DTYPE bfloat16 (or the
    given ``cfg``) at 64 frames x ``res`` px, V = 1, random weights from
    seed 0, on the synthetic batch: one warm-up step, then ``steps`` timed
    steps (CUDA events, peak memory) with the launch counts set to 0 just
    before and read just after; checks a finite loss, frozen parameters
    bit-unchanged, trainable ones changed, the EMA moved, and K1 x12, K3
    forward x6 and backward x6 launches per step."""
    from vgqa_tpu_torch.data.synthetic_batch import synthetic_batch
    from vgqa_tpu_torch.training.trainer import Trainer, batch_to

    if cfg is None:
        cfg = full_cfg(res, **{"TPU.TRAIN_DTYPE": "bfloat16"})
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev, seed=0)
    trainer.setup(max_iter=1000)
    state, step_fn = trainer.state, trainer.step_fn
    model, labels = state.model, state.optimizer.labels
    b = batch_to(synthetic_batch(cfg, seed=0), dev)
    args = (b["video"], b["text"], b["targets"])
    n_train = sum(p.numel() for n, p in model.named_parameters() if labels[n] != "frozen")
    print(f"train model built in {time.perf_counter() - t0:.1f} s: "
          f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, "
          f"{n_train / 1e6:.1f}M trainable; frames {tuple(b['video'].frames.shape)} "
          f"{b['video'].frames.dtype}, dtype {cfg.TPU.TRAIN_DTYPE}")

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = step_fn(state, *args, seed=0)
    first_loss = float(m["loss"])
    print(f"warm-up train step 64f@{res}: {time.perf_counter() - t0:.3f} s "
          f"(loss {first_loss:.4f})")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    ema_before = {n: e.clone() for n, e in state.ema.items()}

    torch.cuda.synchronize()
    reset_launches()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0 = time.perf_counter()
    start.record()
    metrics = [step_fn(state, *args, seed=0) for _ in range(steps)]
    end.record()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    launches = read_launches()
    ms_step = start.elapsed_time(end) / steps
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x["loss"]) for x in metrics]
    print(f"train step 64f@{res} {cfg.TPU.TRAIN_DTYPE} V=1: {ms_step:.1f} ms/step (CUDA events, "
          f"{steps} steps; host {1e3 * host_s / steps:.1f} ms/step), peak memory "
          f"{peak_gb:.2f} GiB  [{card}]")
    print(f"losses {losses}, grad norms {[round(float(x['grad_norm']), 4) for x in metrics]}")
    print("loss terms of the last step: " + json.dumps(
        {k: round(float(v), 5) for k, v in metrics[-1].items() if not k[-1].isdigit()}))
    print(f"launches over {steps} steps: {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss {losses}")
    if launches != {"swin_block_canvas": 12 * steps, "swin_block_fused": 0,
                    "window_attention": 0, "flash_mha_train.fwd": 6 * steps,
                    "flash_mha_train.bwd": 6 * steps,
                    "flash_mha": 0, "flash_gqa_causal": 0, "int4_matmul": 0}:
        raise AssertionError(f"expected 12 / 6 / 6 launches per step, got {launches}")
    frozen_changed = [n for n, p in model.named_parameters()
                      if labels[n] == "frozen" and not torch.equal(p, before[n])]
    trained = [n for n, p in model.named_parameters()
               if labels[n] != "frozen" and not torch.equal(p, before[n])]
    n_trainable = sum(1 for n in labels if labels[n] != "frozen")
    ema_moved = sum(1 for n in state.ema if not torch.equal(state.ema[n], ema_before[n]))
    print(f"parameters changed: {len(trained)} of {n_trainable} trainable, "
          f"{len(frozen_changed)} frozen; EMA leaves moved: {ema_moved}")
    if frozen_changed or len(trained) < 0.9 * n_trainable or ema_moved < 0.9 * n_trainable:
        raise AssertionError(f"frozen changed {frozen_changed[:5]}, trained {len(trained)}, "
                             f"EMA moved {ema_moved}")
    del before, ema_before
    return {"cfg": cfg, "trainer": trainer, "args": args, "ms_step": ms_step,
            "peak_gb": peak_gb, "launches": launches, "losses": losses}


def k3_device_ms(top):
    """K3's device ms (forward, backward) among a profiled step's kernels."""
    return tuple(sum(us for name, us in top if k in name) / 1e3 for k in K3_NAMES)


def train(dev, card):
    from vgqa_tpu_torch.training.optimizer import update_ema

    run = train_steps(dev, card, 224)
    cfg, args, launches, ms_step, peak_gb = (run[k] for k in
                                             ("cfg", "args", "launches", "ms_step", "peak_gb"))
    state, step_fn = run["trainer"].state, run["trainer"].step_fn
    model, labels = state.model, state.optimizer.labels

    # the step's two halves alone: forward + loss + backward, then clip +
    # grouped AdamW + EMA (on the gradients the first half left)
    fb_ms, fb_host = timed(lambda: step_fn.loss_and_grads(state, *args, seed=0))
    opt_ms, opt_host = timed(lambda: (state.optimizer.step(state.step),
                                      update_ema(dict(model.named_parameters()), state.ema,
                                                 cfg.MODEL.EMA_DECAY)))
    print(f"train step halves: forward+loss+backward {fb_ms:.1f} ms (host {fb_host:.1f} ms), "
          f"clip+AdamW+EMA {opt_ms:.1f} ms (host {opt_host:.1f} ms)  [{card}]")

    wall, busy, n_kernels, top = profile_step(lambda: step_fn(state, *args, seed=0))
    k3_fwd, k3_bwd = k3_device_ms(top)
    print(f"profiled train step: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"(idle share {1 - busy / wall:.3f}), {n_kernels} kernel launches; K3 device "
          f"{k3_fwd:.3f} + {k3_bwd:.3f} ms (fwd + bwd, 6 calls each)")
    for name, us in top[:12]:
        print(f"  {us / 1e3:8.3f} ms  {name[:110]}")

    # ---- kernel routes vs plain routes, same state, every dropout rate 0 ----
    from vgqa_tpu_torch.ops.dropout import DropoutRng

    for mod in model.modules():
        if isinstance(getattr(mod, "dropout", None), float):
            mod.dropout = 0.0          # K3 at rate 0, no mask on the einsum route
    rng_dropout = DropoutRng.dropout
    DropoutRng.dropout = lambda self, x, rate: x     # the fixed-rate dropouts too
    res = {}
    for on in (True, False):
        set_kernel_routes(model, on)
        total, _ = step_fn.loss_and_grads(state, *args, seed=5)
        grads = [p.grad for n, p in model.named_parameters()
                 if labels[n] != "frozen" and p.grad is not None]
        res[on] = (float(total), float(torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))))
    DropoutRng.dropout = rng_dropout
    set_kernel_routes(model, True)
    d_loss = abs(res[True][0] - res[False][0]) / abs(res[False][0])
    d_norm = abs(res[True][1] - res[False][1]) / res[False][1]
    print(f"kernel vs plain routes, one train step: loss {res[True][0]:.5f} vs "
          f"{res[False][0]:.5f} (rel {d_loss:.2e}), grad norm {res[True][1]:.4f} vs "
          f"{res[False][1]:.4f} (rel {d_norm:.2e})")
    # bf16 forward and backward through ~100 layers with random weights: the
    # two routes round at other points; a broken kernel (a wrong mask, a wrong
    # gradient) moves the loss or the gradient norm by far more
    if not (d_loss < 2e-2 and d_norm < 5e-2):
        raise AssertionError("kernel and plain routes disagree on the train step")
    return {"ms_step": ms_step, "peak_gb": peak_gb, "launches": launches,
            "k3_device_ms": k3_fwd + k3_bwd}


def train_420(dev, card):
    """The production resolution (configs/grounding_vidstg.yaml trains at
    INPUT.RESOLUTION 420: K3 at [512, 418, 32], rate 0.1): the checked
    steps of :func:`train_steps`, then three steps under the profiler for
    K3's device time and the device busy share."""
    run = train_steps(dev, card, 420)
    state, step_fn, args = run["trainer"].state, run["trainer"].step_fn, run["args"]
    # three profiled steps; the one with K3's median device time is reported
    steps = [profile_step(lambda: step_fn(state, *args, seed=0)) for _ in range(3)]
    k3 = [k3_device_ms(top) for _, _, _, top in steps]
    mid = sorted(range(3), key=lambda i: sum(k3[i]))[1]
    wall, busy, n_kernels, top = steps[mid]
    k3_fwd, k3_bwd = k3[mid]
    print(f"profiled train step 64f@420 (median of 3 by K3 time): wall {wall:.1f} ms, device "
          f"busy {busy:.1f} ms (idle share {1 - busy / wall:.3f}), {n_kernels} kernel "
          f"launches; K3 device {k3_fwd:.3f} + {k3_bwd:.3f} ms (fwd + bwd, 6 calls each; the "
          f"3 steps: {[round(sum(x), 3) for x in k3]})  [{card}]")
    for name, us in top[:12]:
        print(f"  {us / 1e3:8.3f} ms  {name[:110]}")
    return {"ms_step": run["ms_step"], "peak_gb": run["peak_gb"], "launches": run["launches"],
            "k3_device_ms": k3_fwd + k3_bwd, "k3_fwd_ms": k3_fwd, "k3_bwd_ms": k3_bwd,
            "busy_ms": busy, "wall_ms": wall}


def swin_tower_routes(dev, card):
    """The Swin-T tower alone at full width, 64 frames x 224 px, V = 2, bf16,
    random weights from seed 0, through its three block routes: canvas (K1
    x 12), blocks (K1' x 12) and module (plain PyTorch); each route's launch
    counts are set to 0 just before its run and read just after."""
    from vgqa_tpu_torch.models.video_swin import VIDEO_SWIN_CONFIGS, VideoSwinBackbone

    torch.manual_seed(0)
    tower = VideoSwinBackbone(VIDEO_SWIN_CONFIGS["video_swin_t_p4w7"]).to(dev).bfloat16().eval()
    g = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randn(2, 64, 224, 224, 3, generator=g, device=dev).bfloat16()
    want = {"canvas": {"swin_block_canvas": 12}, "blocks": {"swin_block_fused": 12},
            "module": {}}
    outs, res = {}, {}
    with torch.no_grad():
        for route in ("canvas", "blocks", "module"):
            tower(frames, route=route)                       # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            outs[route] = tower(frames, route=route)["3"].float()
            torch.cuda.synchronize()
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            expect = {n: want[route].get(n, 0) for n in launches}
            if launches != expect:
                raise AssertionError(f"tower route {route}: launches {launches}, expected {expect}")
            ms, _ = timed(lambda: tower(frames, route=route), reps=3)
            res[route] = {"ms": ms, "peak_gb": peak, "launches": launches}
    for route in ("blocks", "module"):
        rel, mae = rel_err(outs[route], outs["canvas"])
        res[route].update(rel_vs_canvas=rel, max_abs_vs_canvas=mae)
    print("Swin-T tower 64f@224 V=2 bf16: " + ", ".join(
        f"{r} {v['ms']:.2f} ms (peak {v['peak_gb']:.2f} GiB)" for r, v in res.items())
        + f"; stage-3 rel err vs canvas: blocks {res['blocks']['rel_vs_canvas']:.3e}, module "
        f"{res['module']['rel_vs_canvas']:.3e}  [{card}]")
    for route in ("blocks", "module"):
        if not res[route]["rel_vs_canvas"] < 5e-2:
            raise AssertionError(f"tower route {route} disagrees with the canvas route")
    del tower, frames, outs
    return res


def train_trainable(dev, card):
    """Two bf16 train steps at 64f@224, V = 1, with a trainable Swin tower
    (MODEL.VIDEO_SWIN.FREEZE False: the module route under autograd, DropPath
    from the step's generator; K1 and K1' do not launch)."""
    from vgqa_tpu_torch.data.synthetic_batch import synthetic_batch
    from vgqa_tpu_torch.training.trainer import Trainer, batch_to

    cfg = full_cfg(224, **{"TPU.TRAIN_DTYPE": "bfloat16", "MODEL.VIDEO_SWIN.FREEZE": False})
    trainer = Trainer(cfg, device=dev, seed=0)
    trainer.setup(max_iter=1000)
    state, step_fn = trainer.state, trainer.step_fn
    model, labels = state.model, state.optimizer.labels
    b = batch_to(synthetic_batch(cfg, seed=0), dev)
    args = (b["video"], b["text"], b["targets"])
    swin = {n: p.detach().clone() for n, p in model.named_parameters() if n.startswith("vid.")}
    if any(labels[n] == "frozen" for n in swin):
        raise AssertionError("MODEL.VIDEO_SWIN.FREEZE False left Swin leaves frozen")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms, losses = [], []
    for _ in range(2):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        losses.append(float(step_fn(state, *args, seed=0)["loss"]))
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    changed = sum(1 for n, p in model.named_parameters()
                  if n in swin and not torch.equal(p, swin[n]))
    print(f"train step 64f@224 bf16 V=1, trainable Swin (module route): steps "
          f"{[round(t, 1) for t in step_ms]} ms, peak memory {peak:.2f} GiB  [{card}]")
    print(f"  losses {losses}; Swin parameters changed: {changed} of {len(swin)}; "
          f"launches over 2 steps: {launches}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite train loss {losses}")
    if changed < 0.9 * len(swin):
        raise AssertionError(f"only {changed} of {len(swin)} Swin parameters changed")
    if ((launches["swin_block_canvas"], launches["swin_block_fused"]) != (0, 0)
            or (launches["flash_mha_train.fwd"], launches["flash_mha_train.bwd"]) != (12, 12)):
        raise AssertionError(f"trainable tower: launches {launches}")
    del trainer, state, model, swin
    return {"step_ms": step_ms, "peak_gb": peak, "losses": losses, "launches": launches}


# (dims D, H, W, C, heads, shift, calls per step): the 12 K1 blocks of the
# frozen Swin-T tower in one 64f@420 train step (4x4 patches: 105, then
# patch merging to 53, 27, 14)
K1_420_CASES = [
    ((64, 105, 105), 96, 3, (0, 0, 0), 1), ((64, 105, 105), 96, 3, (4, 3, 3), 1),
    ((64, 53, 53), 192, 6, (0, 0, 0), 1), ((64, 53, 53), 192, 6, (4, 3, 3), 1),
    ((64, 27, 27), 384, 12, (0, 0, 0), 3), ((64, 27, 27), 384, 12, (4, 3, 3), 3),
    ((64, 14, 14), 768, 24, (0, 0, 0), 1), ((64, 14, 14), 768, 24, (4, 3, 3), 1),
]
F32_K1_NAMES = ("ln_rows_kernel<float", "gemm_sm90_kernel<true", "window_attn_f32_kernel")
F32_K3_NAMES = ("train_fwd_f32_kernel", "flash_bwd_f32_kernel")


def check_f32_kernels(dev, g):
    """The float32 forms at the f32 train path's shapes, against their f32
    plain versions (fails above F32_TOL of max |ref|): K1 at the 8 block
    shapes of a 64f@420 step (B = 1, DropPath gates with zeros), K1' on the
    same windows (and against K1 on the canvas), K2 at S = 418, K3 forward
    and backward at [512, 418, 32], rates 0 and 0.1 (keep bits equal to the
    bf16 kernel's and to the plain mask packed). Times by CUDA events and by
    device time (profiler); bounds at the FFMA rate, K1's with its GEMM at
    the 3xTF32 rate (the FFMA one beside it as ``ffma_bound_ms``)."""
    from vgqa_tpu_torch.models.video_swin import window_partition, window_reverse
    from vgqa_tpu_torch.ops.kernels.flash_train import (
        flash_mha_train, flash_train_bwd, flash_train_bwd_reference, flash_train_fwd,
        flash_train_fwd_reference, fold_heads, keep_mask, pack_keep_bits)
    from vgqa_tpu_torch.ops.kernels.swin_block import (
        swin_block_canvas, swin_block_canvas_reference, swin_block_fused,
        swin_block_fused_reference)
    from vgqa_tpu_torch.ops.kernels.window_attention import (
        window_attention, window_attention_reference)

    f32 = torch.float32
    k1_rows = []
    for i, (dims, C, heads, shift, per_step) in enumerate(K1_420_CASES):
        window, shift, padded, N, ws, canvas, bias, region, valid = _swin_case(
            dev, g, dims, C, heads, shift, 1, dtype=f32)
        gates = torch.tensor([[0.0, 1.25]] if i % 2 else [[1.1111, 0.0]], device=dev)
        args = (canvas, *ws, bias, heads, window, shift)
        kw = {"region": region, "valid": valid, "gates": gates}
        out = swin_block_canvas(*args, **kw)
        ref = swin_block_canvas_reference(*args, **kw)
        rolled = torch.roll(canvas, shifts=tuple(-x for x in shift), dims=(1, 2, 3))
        windows = window_partition(rolled, window).contiguous()
        del rolled
        fkw = {"region": region, "valid": valid}
        fout = swin_block_fused(windows, *ws, bias, heads, **fkw)
        fref = swin_block_fused_reference(windows, *ws, bias, heads, **fkw)
        k1_plain = swin_block_canvas(*args, **fkw)          # K1 without gates
        torch.cuda.synchronize()
        rel, mae = rel_err(out, ref)
        frel, fmae = rel_err(fout, fref)
        vs_k1 = rel_err(window_reverse(fout, window, 1, *padded), k1_plain)[1]
        del out, ref, fout, fref, k1_plain
        ms = cuda_ms(lambda: swin_block_canvas(*args, **kw))
        ph = device_phases(lambda: swin_block_canvas(*args, **kw), F32_K1_PHASES,
                           counter=lambda: swin_block_canvas.launches)
        dev_ms = ph["all"]
        fms = cuda_ms(lambda: swin_block_fused(windows, *ws, bias, heads, **fkw))
        plain = cuda_ms(lambda: swin_block_canvas_reference(*args, **kw), reps=2)
        tokens = padded[0] * padded[1] * padded[2]
        nbytes = 2 * tokens * C * 4 + 12 * C * C * 4 + heads * N * N * 4
        ffma_ms = bound(tokens * (24.0 * C * C + 4.0 * N * C), nbytes, PEAK_F32)[0]
        # the bound of this design: the GEMM's three tf32 products at the
        # dense TF32 rate, the attention at the FFMA rate, or the bytes
        ops_ms = 1e3 * (3 * tokens * 24.0 * C * C / PEAK_TF32 + tokens * 4.0 * N * C / PEAK_F32)
        b_ms = max(ops_ms, 1e3 * nbytes / PEAK_BYTES)
        b_by = "operations" if b_ms == ops_ms else "bytes"
        k1_rows.append({"dims": dims, "C": C, "shift": shift, "per_step": per_step,
                        "rel_err": rel, "max_abs_err": mae, "fused_rel_err": frel,
                        "fused_max_abs_err": fmae, "fused_vs_k1_max_abs": vs_k1, "ms": ms,
                        "device_ms": dev_ms, "gemm_device_ms": ph["gemm"],
                        "attn_device_ms": ph["attn"], "ln_device_ms": ph["ln"],
                        "fused_ms": fms, "plain_ms": plain,
                        "bound_ms": b_ms, "bound_by": b_by, "ffma_bound_ms": ffma_ms})
        print(f"K1 f32 swin_block_canvas B=1 {dims}->{padded} C={C} h={heads} roll={shift}: "
              f"rel_err {rel:.3e}  K1' rel_err {frel:.3e} (vs K1 max abs {vs_k1:.3e})  kernel "
              f"{ms:.3f} ms (device {dev_ms:.3f} = gemm {ph['gemm']:.3f} + attn "
              f"{ph['attn']:.3f} + ln {ph['ln']:.3f})  K1' {fms:.3f} ms  plain(f32) {plain:.3f} "
              f"ms  bound {b_ms:.3f} ms ({b_by}: 3xTF32 GEMM + FFMA attention); all on FFMA "
              f"{ffma_ms:.3f} ms")
        if not (rel < F32_TOL and frel < F32_TOL and vs_k1 < F32_TOL):
            raise AssertionError(f"f32 K1/K1' {dims} C={C}: rel_err {rel}, {frel}, vs K1 {vs_k1}")
        if not (ph["gemm"] > 0 and ph["attn"] > 0):
            raise AssertionError(f"f32 swin_block_canvas {dims}: device phases {ph}")
        del windows, canvas, ws
    torch.cuda.empty_cache()

    # K2 at the 420 px encoder rows
    W, S, C, H = 128, 418, 256, 8
    q, k, v = (torch.randn(W, S, C, generator=g, device=dev) for _ in range(3))
    kv = (torch.rand(W, S, generator=g, device=dev) > 0.1).float()
    kv[:, 0] = 1.0
    out = window_attention(q, k, v, key_valid=kv, num_heads=H)
    ref = window_attention_reference(q, k, v, key_valid=kv, num_heads=H)
    torch.cuda.synchronize()
    rel, mae = rel_err(out, ref)
    ms = cuda_ms(lambda: window_attention(q, k, v, key_valid=kv, num_heads=H))
    dev_ms = device_kernels(lambda: window_attention(q, k, v, key_valid=kv, num_heads=H),
                            names=("window_attn_f32_kernel",))[2]
    plain = cuda_ms(lambda: window_attention_reference(q, k, v, key_valid=kv, num_heads=H))
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def heads(t):
        return t.reshape(t.shape[0], t.shape[1], H, -1).transpose(1, 2)

    am = (kv > 0)[:, None, None, :]

    def library():                     # SDPA on the same f32 operands (the port never calls it)
        return sdpa(heads(q), heads(k), heads(v), attn_mask=am)

    lib = cuda_ms(library)
    lib_dev = device_kernels(library)[3]
    b_ms, b_by = bound(4.0 * W * S * S * C, 4 * W * S * C * 4 + W * S * 4, PEAK_F32)
    k2_row = {"S": S, "rel_err": rel, "max_abs_err": mae, "ms": ms, "device_ms": dev_ms,
              "plain_ms": plain, "library_ms": lib, "library_device_ms": lib_dev,
              "bound_ms": b_ms, "bound_by": b_by}
    print(f"K2 f32 window_attention W=128 S=418 C=256 h=8: rel_err {rel:.3e}  kernel {ms:.4f} "
          f"ms (device {dev_ms:.4f})  plain(f32) {plain:.3f} ms  sdpa(f32) {lib:.4f} ms (device "
          f"{lib_dev:.4f})  bound {b_ms:.4f} ms ({b_by}, FFMA)")
    if not rel < F32_TOL:
        raise AssertionError(f"f32 window_attention: rel_err {rel}")
    del q, k, v, out, ref

    # K3 at [512, 418, 32]
    k3_rows = []
    W, L, H, D = 64, 418, 8, 32
    scale = D ** -0.5
    q, k, v, do = (torch.randn(W, L, H * D, generator=g, device=dev) for _ in range(4))
    mask = torch.rand(W, L, generator=g, device=dev) > 0.1
    mask[:, 0] = True
    fq, fk, fv, fdo = (fold_heads(t, H) for t in (q, k, v, do))
    maskf = mask.repeat_interleave(H, dim=0)
    for rate in (0.0, 0.1):
        args = (mask, 4242, rate, scale, H)
        out, lse, bits = flash_train_fwd(q, k, v, *args)
        grads = flash_train_bwd(q, k, v, out, do, lse, bits, mask, rate, scale, H)
        r_out, r_lse = flash_train_fwd_reference(fq, fk, fv, maskf, 4242, rate, scale)
        r_grads = flash_train_bwd_reference(fq, fk, fv, r_out, fdo, r_lse, maskf, 4242, rate,
                                            scale)
        errs = {"out": rel_err(fold_heads(out, H), r_out)}
        errs.update({n: rel_err(fold_heads(a, H), b)
                     for n, a, b in zip(("dq", "dk", "dv"), grads, r_grads)})
        lse_err = float((lse - r_lse).abs().max())
        bits_equal = None
        if rate > 0:
            bf_bits = flash_train_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(), *args)[2]
            bits_equal = bool(torch.equal(bits, bf_bits)) and bool(torch.equal(
                bits, pack_keep_bits(keep_mask(4242, W * H, L, L, rate, dev))))
        del grads, r_grads, r_out, r_lse
        bwd_args = (q, k, v, out, do, lse, bits, mask, rate, scale, H)
        fwd_ms = cuda_ms(lambda: flash_train_fwd(q, k, v, *args))
        bwd_ms = cuda_ms(lambda: flash_train_bwd(*bwd_args))
        fwd_n, fwd_k, fwd_dev = device_kernels(lambda: flash_train_fwd(q, k, v, *args),
                                               names=F32_K3_NAMES,
                                               counter=lambda: flash_mha_train.fwd_launches)[:3]
        bwd_n, bwd_k, bwd_dev = device_kernels(lambda: flash_train_bwd(*bwd_args),
                                               names=F32_K3_NAMES,
                                               counter=lambda: flash_mha_train.bwd_launches)[:3]
        # SDPA on the same f32 operands: forward + backward by CUDA events at
        # rate 0, forward and backward apart by device time at this rate
        qh, kh, vh = (heads(t).detach().requires_grad_() for t in (q, k, v))
        doh, am = heads(do), mask[:, None, None, :]
        lib_ms = None
        if rate == 0.0:
            def library():
                torch.autograd.grad(sdpa(qh, kh, vh, attn_mask=am), (qh, kh, vh), doh)

            lib_ms = cuda_ms(library)
        lib_fwd = device_kernels(lambda: sdpa(qh, kh, vh, attn_mask=am, dropout_p=rate))[3]
        o_lib = sdpa(qh, kh, vh, attn_mask=am, dropout_p=rate)
        lib_bwd = device_kernels(lambda: torch.autograd.grad(o_lib, (qh, kh, vh), doh,
                                                             retain_graph=True))[3]
        del o_lib, qh, kh, vh
        B, elems = W * H, W * H * L * D
        f_ms, f_by = bound(4.0 * B * L * L * D, 4 * elems * 4 + B * L * 4 + W * L, PEAK_F32)
        b_ms, b_by = bound(10.0 * B * L * L * D, 8 * elems * 4 + B * L * 4 + W * L, PEAK_F32)
        row = {"L": L, "rate": rate, "max_rel_err": max(e[0] for e in errs.values()),
               "max_abs_err": max(e[1] for e in errs.values()), "lse_abs_err": lse_err,
               "fwd_ms": fwd_ms, "bwd_ms": bwd_ms, "fwd_device_ms": fwd_dev,
               "bwd_device_ms": bwd_dev, "fwd_bound_ms": f_ms, "bwd_bound_ms": b_ms,
               "library_ms": lib_ms, "library_fwd_device_ms": lib_fwd,
               "library_bwd_device_ms": lib_bwd,
               "bound_by": "bytes" if "bytes" in (f_by, b_by) else "operations",
               "exp_floor_ms": 1e3 * B * L * L / EXP_PER_S,
               "kernels_per_call": {"fwd": (fwd_n, fwd_k), "bwd": (bwd_n, bwd_k)},
               "keep_bits_equal_bf16": bits_equal}
        k3_rows.append(row)
        print(f"K3 f32 flash_mha_train [512, 418, 32] rate={rate}: rel_err "
              + " ".join(f"{n} {e[0]:.3e}" for n, e in errs.items())
              + f"  lse abs {lse_err:.2e}  fwd {fwd_ms:.4f} + bwd {bwd_ms:.4f} ms (events), "
              f"device {fwd_dev:.4f} + {bwd_dev:.4f} ms  sdpa(f32) fwd+bwd "
              + ("-" if lib_ms is None else f"{lib_ms:.4f} ms")
              + f" (events), device {lib_fwd:.4f} + {lib_bwd:.4f} ms at dropout_p={rate}  "
              f"bound fwd {f_ms:.4f} bwd {b_ms:.4f} ms (FFMA)  kernels per call {row['kernels_per_call']}  keep bits = bf16 kernel's "
              f"= plain mask packed: {bits_equal}")
        if not (row["max_rel_err"] < F32_TOL and lse_err < 1e-4):
            raise AssertionError(f"f32 flash_mha_train rate={rate}: {errs}, lse {lse_err}")
        if bits_equal is False or fwd_k != 1 or bwd_k != 1:
            raise AssertionError(f"f32 flash_mha_train rate={rate}: keep bits {bits_equal}, "
                                 f"kernels {row['kernels_per_call']}")
        del out, lse, bits
    del q, k, v, do, fq, fk, fv, fdo
    torch.cuda.empty_cache()
    return {"k1": k1_rows, "k2": k2_row, "k3": k3_rows}


def train_f32(dev, card):
    """The production config, configs/grounding_vidstg.yaml, read by the
    port's merge_from_file as the file leaves it (TPU.TRAIN_DTYPE float32,
    64 frames at 420 px, V = 1, the frozen tower; its absent checkpoints
    are not loaded: random weights from seed 0; OUTPUT_DIR emptied, so no
    checkpoint is read or written): the checked steps of
    :func:`train_steps` (a warm-up and 2 timed), then one step under the
    profiler: K1's and K3's device ms, and that their f32 kernels ran and
    their bf16 ones did not."""
    import os

    from vgqa_tpu_torch.config import build_default_cfg

    cfg = build_default_cfg()
    cfg.merge_from_file(os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs",
                                     "grounding_vidstg.yaml"))
    cfg.OUTPUT_DIR = ""
    cfg.freeze()
    got = (cfg.TPU.TRAIN_DTYPE, cfg.INPUT.RESOLUTION, cfg.INPUT.TRAIN_SAMPLE_NUM,
           cfg.SOLVER.BATCH_SIZE, cfg.MODEL.VIDEO_SWIN.FREEZE, cfg.TPU.USE_PALLAS_ATTENTION)
    if got != ("float32", 420, 64, 1, True, True):
        raise AssertionError(f"configs/grounding_vidstg.yaml read as {got}")
    run = train_steps(dev, card, 420, cfg=cfg, steps=2)
    state, step_fn, args = run["trainer"].state, run["trainer"].step_fn, run["args"]
    wall, busy, n_kernels, top = profile_step(lambda: step_fn(state, *args, seed=0))
    names = [n for n, _ in top]
    k1_ms = sum(us for n, us in top if any(k in n for k in F32_K1_NAMES)) / 1e3
    k3_fwd, k3_bwd = (sum(us for n, us in top if k in n) / 1e3 for k in F32_K3_NAMES)
    print(f"profiled f32 train step 64f@420: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"(idle share {1 - busy / wall:.3f}), {n_kernels} kernel launches; K1 device "
          f"{k1_ms:.3f} ms (12 calls), K3 device {k3_fwd:.3f} + {k3_bwd:.3f} ms (6 + 6)  [{card}]")
    for name, us in top[:12]:
        print(f"  {us / 1e3:8.3f} ms  {name[:110]}")
    # the measured option beside the policy: cuDNN's TF32 convolutions
    # (PyTorch's default), cuBLAS still f32; then the policy again
    from vgqa_tpu_torch.utils.device import apply_precision_policy

    torch.backends.cudnn.allow_tf32 = True
    step_fn(state, *args, seed=0)             # a warm-up step at this setting
    tf32_ms, _ = timed(lambda: step_fn(state, *args, seed=0), reps=2)
    apply_precision_policy()
    print(f"f32 train step 64f@420: {run['ms_step']:.1f} ms/step all-f32 (the entry points' "
          f"policy: TF32 off in cuBLAS and cuDNN) vs {tf32_ms:.1f} ms/step with cuDNN's TF32 "
          f"convolutions (a measured option, not the policy; CUDA events, 2 steps)  [{card}]")
    ran = all(any(k in n for n in names) for k in F32_K1_NAMES[1:] + F32_K3_NAMES)
    bf16_ran = [n for n in names if "gemm_sm90_kernel<false" in n or "attn_fwd_kernel<32" in n
                or "flash_bwd_kernel" in n or K2_NAMES[0] in n]
    if not ran or bf16_ran:
        raise AssertionError(f"f32 step: f32 kernels ran {ran}, bf16 kernels {bf16_ran}")
    del run["trainer"], state
    return {"ms_step": run["ms_step"], "peak_gb": run["peak_gb"], "launches": run["launches"],
            "losses": run["losses"], "k1_device_ms": k1_ms, "k3_device_ms": k3_fwd + k3_bwd,
            "busy_ms": busy, "wall_ms": wall, "cudnn_tf32_ms_step": tf32_ms}


# the keys of the metrics dict that tools/evaluate.py prints for a split with
# both question types: "{qtype}_{name}" (vgqa_tpu/data/metrics/evaluator.py,
# VidSTGEvaluator.summarize)
VIDSTG_METRIC_KEYS = {f"{q}_{m}" for q in ("declar", "inter") for m in (
    "tiou", "viou", "gt_viou", "kf_p", "kf_r", "viou@0.3", "gt_viou@0.3", "viou@0.5",
    "gt_viou@0.5")}
VIDSTG_SIZE, VIDSTG_FRAMES = (640, 360), 200     # the synthetic videos: w x h, frames


def write_vidstg_set(data):
    """The synthetic VidSTG set of the data-path phases: annotations of 4
    train videos (seed 0) and 2 test videos (seed 100), 640x360, 200 frames
    (8 train and 4 test items), no video files."""
    from vgqa_tpu_torch.data.synthetic import make_synthetic_dataset

    make_synthetic_dataset(data, num_videos=4, frames_per_video=VIDSTG_FRAMES,
                           size=VIDSTG_SIZE, splits=("train",), seed=0, write_videos=False)
    make_synthetic_dataset(data, num_videos=2, frames_per_video=VIDSTG_FRAMES,
                           size=VIDSTG_SIZE, splits=("test",), seed=100, write_videos=False)


def rendered_frames():
    """A ``read_frames`` for the dataset module that serves the renderer's
    frames of :func:`write_vidstg_set`'s videos (the card machine has no
    video decoder), every video rendered here, in set-up, not in the steps."""
    from vgqa_tpu_torch.data.synthetic import frame_reader

    readers = {"train": frame_reader(VIDSTG_FRAMES, VIDSTG_SIZE, seed=0),
               "test": frame_reader(VIDSTG_FRAMES, VIDSTG_SIZE, seed=100)}
    for split, n in (("train", 4), ("test", 2)):
        for i in range(n):
            readers[split](f"{split}_vid{i:03d}.mp4", [0])
    return lambda path, ids, *a, **kw: readers[os.path.basename(path).split("_")[0]](path, ids)


def train_vidstg(dev, card):
    """Training over the VidSTG data path, as ``python -m
    vgqa_tpu_torch.tools.train`` then ``.evaluate`` run it, at full width:
    configs/grounding_vidstg.yaml read by the port's merge_from_file
    (float32, 64f@420, ResNet-101, Video Swin-T, RoBERTa-base,
    DATALOADER.NUM_WORKERS 8, random weights from seed 0: MODEL.WEIGHT does
    not exist here) over a synthetic VidSTG set that the port's
    ``make_synthetic_dataset`` writes (annotations only: 4 train and 2 test
    videos of 640x360 and 200 frames; 8 train and 4 test items). The card
    machine has no video decoder, so the dataset module's ``read_frames``
    serves the renderer's frames (``synthetic.frame_reader``); from clip
    sampling on, everything is the port's. One epoch (8 steps as ``fit``
    runs them, timed over steps 3-8 and 3-6 with a sync only at the windows'
    ends; steps 7-8 profiled),
    ``test`` (``do_eval`` on the 4 test items, 128 frames in two 64-frame
    half-passes), then the evaluate tool on ``model_final_params``. Checks
    exact K1 / K2 / K3 launches per train step and per eval half-pass, a
    finite loss, and the evaluate tool's metric keys."""
    from vgqa_tpu_torch.config import build_default_cfg
    from vgqa_tpu_torch.data import dataset as dataset_mod
    from vgqa_tpu_torch.tools import evaluate as evaluate_tool

    here = os.path.dirname(os.path.abspath(__file__))
    yaml_path = os.path.join(here, "configs", "grounding_vidstg.yaml")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_vidstg_", dir=here) as root:
        data, out = os.path.join(root, "data"), os.path.join(root, "out")
        write_vidstg_set(data)
        real_read = dataset_mod.read_frames
        dataset_mod.read_frames = rendered_frames()
        print("train_vidstg: no video decoder on this machine: the dataset reads the "
              "synthetic renderer's frames (data/synthetic.frame_reader, uncompressed) "
              "in place of video_io.read_frames")
        opts = ["DATA_DIR", data, "OUTPUT_DIR", out, "TENSORBOARD_DIR", ""]
        try:
            cfg = build_default_cfg()
            cfg.merge_from_file(yaml_path)
            cfg.merge_from_list(opts)
            cfg.freeze()
            got = (cfg.TPU.TRAIN_DTYPE, cfg.INPUT.RESOLUTION, cfg.INPUT.TRAIN_SAMPLE_NUM,
                   cfg.DATALOADER.NUM_WORKERS, cfg.INPUT.MAX_VIDEO_LEN, cfg.TPU.UINT8_FEED)
            if got != ("float32", 420, 64, 8, 200, True):
                raise AssertionError(f"configs/grounding_vidstg.yaml read as {got}")
            res = _vidstg_run(cfg, dev, card, out)
            # the evaluate tool on the params twin, as `python -m ...tools.evaluate`
            buf = io.StringIO()
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                evaluate_tool.main(["--config-file", yaml_path, *opts, "MODEL.WEIGHT_EVAL",
                                    os.path.join(out, "model_final_params")])
            torch.cuda.synchronize()
            eval_tool_s = time.perf_counter() - t0
            tool_launches = read_launches()
        finally:
            dataset_mod.read_frames = real_read
    lines = buf.getvalue().splitlines()
    metrics = json.loads("\n".join(lines[max(i for i, x in enumerate(lines) if x == "{"):]))
    if "Loaded eval weights" not in buf.getvalue():
        raise AssertionError("the evaluate tool did not load model_final_params")
    print(f"evaluate tool on model_final_params: {eval_tool_s:.1f} s for 4 test items "
          f"(model build included); launches {tool_launches}  [{card}]")
    print("evaluate tool metrics (random weights): " + json.dumps(metrics))
    if set(metrics) != VIDSTG_METRIC_KEYS or not all(np.isfinite(list(metrics.values()))):
        raise AssertionError(f"evaluate tool printed {sorted(metrics)}")
    want_eval = {"swin_block_canvas": 12 * 8, "swin_block_fused": 0, "window_attention": 6 * 8,
                 "flash_mha_train.fwd": 0, "flash_mha_train.bwd": 0, "flash_mha": 0,
                 "flash_gqa_causal": 0, "int4_matmul": 0}
    if tool_launches != want_eval:
        raise AssertionError(f"evaluate tool: expected 12 K1 / 6 K2 per half-pass, got "
                             f"{tool_launches}")
    res["launches"] = {k: res["launches"][k] + tool_launches[k] for k in tool_launches}
    res.update(eval_tool_s=eval_tool_s, metrics=metrics)
    return res


def _vidstg_run(cfg, dev, card, out):
    """Setup, one epoch and ``test`` of :func:`train_vidstg`."""
    from torch.profiler import ProfilerActivity, profile

    from vgqa_tpu_torch.training.trainer import Trainer
    from vgqa_tpu_torch.utils.log_setup import setup_logger

    logger = setup_logger("Video Grounding", out)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, device=dev, seed=0, logger=logger)
    trainer.setup()
    print(f"train_vidstg: trainer set up in {time.perf_counter() - t0:.1f} s; max_iter "
          f"{trainer.max_iter}")
    if trainer.max_iter != 8:       # 8 train items, batch 1, one epoch
        raise AssertionError(f"one epoch of 8 train items is {trainer.max_iter} steps")

    step_fn, marks = trainer.step_fn, {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def windowed(state, *args, **kw):
        """The trainer's step as ``fit`` runs it, but for three
        synchronisations: before step 3, after step 6 and after step 8 (the
        ends of the timed windows 3-8 and 3-6); steps 7-8 under the
        profiler, their window from the sync after step 6."""
        done = state.step                     # steps taken before this one
        if done == 2:
            torch.cuda.synchronize()
            marks[2] = time.perf_counter()
        if done == 6:
            torch.cuda.synchronize()
            marks[6] = time.perf_counter()
            prof.__enter__()
        metrics = step_fn(state, *args, **kw)
        if done == 7:
            torch.cuda.synchronize()
            marks[8] = time.perf_counter()
            prof.__exit__(None, None, None)
        return metrics

    windowed.loss_and_grads = step_fn.loss_and_grads     # the step's interface
    trainer.step_fn = windowed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    logged = trainer.fit()
    fit_s = time.perf_counter() - t0
    fit_launches = read_launches()
    train_peak = torch.cuda.max_memory_allocated() / 2 ** 30

    steps = trainer.step_log                  # (step, loader wait s, host step s)
    wait = [d for _, d, _ in steps]
    s_step = (marks[8] - marks[2]) / 6
    s_step_36 = (marks[6] - marks[2]) / 4
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -1.0
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    busy_ms, wall_ms = busy / 1e3, 1e3 * (marks[8] - marks[6])
    wait_step = statistics.median(wait[2:8])
    print(f"train_vidstg fit: 8 steps in {fit_s:.1f} s (2 checkpoints saved at the end); "
          f"s/step {s_step:.3f} over steps 3-8 (one sync at each end and one after step 6; "
          f"steps 7-8 profiled), {s_step_36:.3f} over steps 3-6 unprofiled; loader wait "
          f"{wait_step:.3f} s/step (median of steps 3-8), {sum(wait[2:8]) / (6 * s_step):.3f} "
          f"of the step time; device idle share {1 - busy_ms / wall_ms:.3f} over steps 7-8 "
          f"({busy_ms:.1f} ms busy of {wall_ms:.1f} ms, {len(spans)} kernels); peak "
          f"{train_peak:.2f} GiB  [{card}]")
    print(f"  per step by the trainer's clock (step, loader wait s, host step s): "
          f"{[(s, round(d, 3), round(t, 3)) for s, d, t in steps]}")
    print(f"  logged: {json.dumps(logged[-1])}")
    print(f"  launches over the 8 steps: {fit_launches}")
    loss = logged[-1]["loss"]
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    want = {"swin_block_canvas": 12 * 8, "swin_block_fused": 0, "window_attention": 0,
            "flash_mha_train.fwd": 6 * 8, "flash_mha_train.bwd": 6 * 8, "flash_mha": 0,
            "flash_gqa_causal": 0, "int4_matmul": 0}
    if fit_launches != want:
        raise AssertionError(f"expected 12 K1 / 6 + 6 K3 per train step, got {fit_launches}")
    for name in ("model_final", "model_final_params"):
        if not os.path.exists(os.path.join(out, name)):
            raise AssertionError(f"{name} was not written")

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    results = trainer.test()
    torch.cuda.synchronize()
    test_s = time.perf_counter() - t0
    test_launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"train_vidstg test (do_eval, 4 items x 128 frames, 2 half-passes each): "
          f"{test_s / 4:.3f} s/test item; peak over fit and test {peak:.2f} GiB; launches "
          f"{test_launches}  [{card}]")
    want = {"swin_block_canvas": 12 * 8, "swin_block_fused": 0, "window_attention": 6 * 8,
            "flash_mha_train.fwd": 0, "flash_mha_train.bwd": 0, "flash_mha": 0,
            "flash_gqa_causal": 0, "int4_matmul": 0}
    if test_launches != want:
        raise AssertionError(f"expected 12 K1 / 6 K2 per half-pass, got {test_launches}")
    if set(results) != VIDSTG_METRIC_KEYS:
        raise AssertionError(f"test printed {sorted(results)}")
    del trainer, step_fn
    gc.collect()
    torch.cuda.empty_cache()
    return {"s_step": s_step, "s_step_unprofiled": s_step_36, "loader_wait_s": wait_step,
            "idle_share": 1 - busy_ms / wall_ms,
            "eval_s_item": test_s / 4, "peak_gb": peak, "train_peak_gb": train_peak,
            "launches": {k: fit_launches[k] + test_launches[k] for k in fit_launches},
            "fit_launches": fit_launches, "test_launches": test_launches}


DDP_WORLD = 2            # gloo ranks that share card 0 in train_ddp
DDP_TIMEOUT = 900        # seconds a rank may take (and wait in a collective) in train_ddp


@contextlib.contextmanager
def no_dropout():
    """Every dropout off and every DropPath branch kept (gates 1 / keep), so
    a step is a function of its batch alone. MODEL.VSTG.DROPOUT 0 turns off
    the configured rates (K3's included); the text tower's, the classifier
    blocks', the MLP heads' and the decoder queries' fixed rates and the
    Swin's DropPath are not config keys."""
    from vgqa_tpu_torch.ops.dropout import DropoutRng

    saved = DropoutRng.dropout, DropoutRng.bernoulli
    DropoutRng.dropout = lambda self, x, rate: x
    DropoutRng.bernoulli = lambda self, p: torch.ones(p.shape, dtype=torch.bool, device=p.device)
    try:
        yield
    finally:
        DropoutRng.dropout, DropoutRng.bernoulli = saved


def ddp_compare_batch(cfg, ranks):
    """The collated synthetic videos of ``ranks`` (video r from seed r; video
    1 is an eighth of the clip short, so the valid-frame counts differ)."""
    from vgqa_tpu_torch.data.collate import collate
    from vgqa_tpu_torch.data.synthetic_batch import synthetic_sample
    from vgqa_tpu_torch.data.tokenizer import build_tokenizer

    samples = []
    for r in ranks:
        s = synthetic_sample(cfg, seed=r)
        if r == 1:
            cut = len(s["frames"]) - max(1, len(s["frames"]) // 8)
            s = {**s, "frames": s["frames"][:cut], "actioness": s["actioness"][:cut]}
        samples.append(s)
    return collate(samples, build_tokenizer(cfg.MODEL.TEXT_MODEL.VOCAB_DIR),
                   cfg.INPUT.TRAIN_SAMPLE_NUM, cfg.INPUT.MAX_QUERY_LEN, cfg.DATASET.APP_NUM,
                   cfg.DATASET.MOT_NUM)


def ddp_first_step(cfg, dev, ranks):
    """The metrics of one dropout-free step from the seeded initialization
    (seed 0) on the videos ``ranks``, averaged over the data-parallel group
    (each rank passes its own video; one process passes both, V = 2)."""
    from vgqa_tpu_torch.data.collate import batch_to
    from vgqa_tpu_torch.parallel.distributed import reduce_mean
    from vgqa_tpu_torch.training.trainer import Trainer

    with no_dropout():
        trainer = Trainer(cfg, device=dev, seed=0)
        trainer.setup(max_iter=4)
        b = batch_to(ddp_compare_batch(cfg, ranks), dev)
        out = reduce_mean(trainer.step_fn(trainer.state, b["video"], b["text"], b["targets"],
                                          seed=0))
    del trainer, b
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _ddp_rank(rank, world, port, backend, device, job, queue):
    """One rank of :func:`train_ddp`, in a spawned process: its result, or
    its traceback before it re-raises, goes to ``queue``."""
    try:
        queue.put((rank, _ddp_rank_run(rank, world, port, backend, device, job)))
    except BaseException:
        import traceback

        queue.put((rank, {"error": traceback.format_exc()}))
        raise


def _ddp_rank_run(rank, world, port, backend, device, job):
    import hashlib

    from torch.profiler import ProfilerActivity, profile

    from vgqa_tpu_torch.config import build_default_cfg
    from vgqa_tpu_torch.data import dataset as dataset_mod
    from vgqa_tpu_torch.parallel import distributed
    from vgqa_tpu_torch.tools import train as train_tool
    from vgqa_tpu_torch.training.trainer import Trainer

    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        os.environ.pop(key, None)
    os.environ.update(VGQA_COORDINATOR=f"localhost:{port}", VGQA_NUM_PROCESSES=str(world),
                      VGQA_PROCESS_ID=str(rank), VGQA_SHUTDOWN_TIMEOUT=str(DDP_TIMEOUT))
    for key in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME"):    # every rank on this host
        os.environ.setdefault(key, "lo")
    dataset_mod.read_frames = rendered_frames()
    distributed.initialize_multihost(backend=backend, device=device)
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": rank, "world": distributed.get_world_size(), "device": str(dev)}
    if job["compare"]:
        cfg = build_default_cfg()
        cfg.merge_from_file(job["yaml"])
        cfg.merge_from_list(job["opts"] + ["MODEL.VSTG.DROPOUT", "0.0", "OUTPUT_DIR", ""])
        cfg.freeze()
        out["first_step"] = ddp_first_step(cfg, dev, [rank])

    seen, marks, reduces, saved = {}, {}, [], []
    if rank == 0:         # the profiler's first session in a process is slow: not in the step
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=dev).add_(1)
            torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    real = (Trainer.setup, Trainer.fit, Trainer.test, distributed.average_gradients,
            torch.save)

    def setup(self, *a, **kw):
        """The trainer's setup; its step synchronised before step 2 and
        before and after the last step, which rank 0 profiles."""
        real[0](self, *a, **kw)
        seen["trainer"] = self
        step_fn, last = self.step_fn, self.max_iter - 1

        def step(state, *args, **kwargs):
            done = state.step
            if done in (1, last):
                if done == last and rank == 0:
                    prof.__enter__()         # its start-up outside the window
                torch.cuda.synchronize()
                marks[done] = time.perf_counter()
            metrics = step_fn(state, *args, **kwargs)
            if done == last:
                torch.cuda.synchronize()
                marks["end"] = time.perf_counter()
                if rank == 0:
                    prof.__exit__(None, None, None)
            return metrics

        step.loss_and_grads = step_fn.loss_and_grads
        self.step_fn = step

    def fit(self, *a, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        logged = real[1](self, *a, **kw)
        torch.cuda.synchronize()
        seen.update(fit_launches=read_launches(), logged=logged,
                    train_peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
        return logged

    def test(self):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        seen["metrics"] = real[2](self)
        torch.cuda.synchronize()
        seen.update(test_launches=read_launches(), test_s=time.perf_counter() - t0)
        return seen["metrics"]

    def average_gradients(params, *a, **kw):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        n = real[3](params, *a, **kw)
        end.record()
        reduces.append((start, end, n))
        return n

    def save(obj, f, *a, **kw):
        saved.append(os.path.basename(str(f)))
        return real[4](obj, f, *a, **kw)

    Trainer.setup, Trainer.fit, Trainer.test = setup, fit, test
    distributed.average_gradients, torch.save = average_gradients, save
    argv = ["--config-file", job["yaml"], *(["--device", device] if device else []),
            *(["--skip-test"] if job["skip_test"] else []), *job["opts"]]
    try:
        out["code"] = train_tool.main(argv)
    finally:
        Trainer.setup, Trainer.fit, Trainer.test = real[:3]
        distributed.average_gradients, torch.save = real[3:]
    trainer = seen.pop("trainer")
    torch.cuda.synchronize()
    last = trainer.max_iter - 1
    h = hashlib.sha256()
    for t in [*trainer.state.model.parameters(), *trainer.state.ema.values()]:
        h.update(t.detach().cpu().numpy().tobytes())
    if rank == 0:
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
        busy, end = 0.0, -1.0
        for a, b in spans:
            if b > end:
                busy += b - max(a, end)
                end = b
        wall_ms = 1e3 * (marks["end"] - marks[last])
        out.update(profiled_busy_ms=busy / 1e3, profiled_wall_ms=wall_ms,
                   idle_share=1 - busy / 1e3 / wall_ms, profiled_kernels=len(spans))
    out.update(seen, max_iter=trainer.max_iter, final_step=trainer.state.step,
               saved=saved, digest=h.hexdigest(),
               # steps 2 .. max_iter - 1, or the profiled step alone when there are 2
               s_step=((marks[last] - marks[1]) / (last - 1) if last > 1
                       else marks["end"] - marks[last]),
               allreduce_ms=[s.elapsed_time(e) for s, e, _ in reduces],
               allreduce_bytes=[n for _, _, n in reduces],
               peak_gb=torch.cuda.max_memory_allocated() / 2 ** 30)
    del trainer
    distributed.destroy()
    return out


def run_ranks(world, backend, device, job):
    """:func:`_ddp_rank` in ``world`` spawned processes (the parent holds a
    CUDA context, so not forked); their results in rank order. A rank that
    fails, exits without a result or outlasts DDP_TIMEOUT fails the phase,
    and every rank is stopped."""
    import multiprocessing
    import queue as queue_mod
    import socket

    ctx = multiprocessing.get_context("spawn")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    queue = ctx.Queue()
    procs = [ctx.Process(target=_ddp_rank, args=(r, world, port, backend, device, job, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.time() + DDP_TIMEOUT
    try:
        while len(results) < world:
            try:
                rank, res = queue.get(timeout=5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in results]
                if dead or time.time() > deadline:
                    raise AssertionError(f"train_ddp ({backend}): ranks {dead} exited "
                                         f"without a result, or the run passed "
                                         f"{DDP_TIMEOUT} s") from None
                continue
            if "error" in res:
                raise AssertionError(f"train_ddp ({backend}) rank {rank} failed:\n{res['error']}")
            results[rank] = res
        for p in procs:
            p.join(timeout=120)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"train_ddp ({backend}): exit codes {[p.exitcode for p in procs]}")
    return [results[r] for r in range(world)]


def _check_ddp_run(ranks, name, steps, test_items, skip_test):
    """The checks every data-parallel run of ``steps`` steps must pass (see
    :func:`train_ddp`); returns the launches summed over its ranks."""
    world = len(ranks)
    want_fit = {"swin_block_canvas": 12 * steps, "swin_block_fused": 0, "window_attention": 0,
                "flash_mha_train.fwd": 6 * steps, "flash_mha_train.bwd": 6 * steps,
                "flash_mha": 0, "flash_gqa_causal": 0, "int4_matmul": 0}
    halves = 0 if skip_test else 2 * -(-test_items // world)
    want_test = {**{k: 0 for k in want_fit}, "swin_block_canvas": 12 * halves,
                 "window_attention": 6 * halves}
    for r in ranks:
        tag = f"{name} rank {r['rank']}"
        if (r["code"], r["world"], r["max_iter"], r["final_step"]) != (0, world, steps, steps):
            raise AssertionError(f"{tag}: code/world/max_iter/final step {r['code']}, "
                                 f"{r['world']}, {r['max_iter']}, {r['final_step']}; want "
                                 f"0, {world}, {steps}, {steps}")
        if r["fit_launches"] != want_fit:
            raise AssertionError(f"{tag}: expected 12 K1 / 6 + 6 K3 per step, got "
                                 f"{r['fit_launches']}")
        if not skip_test and r["test_launches"] != want_test:
            raise AssertionError(f"{tag}: expected 12 K1 / 6 K2 per eval half-pass "
                                 f"({halves}), got {r['test_launches']}")
        if not np.isfinite(r["logged"][-1]["loss"]):
            raise AssertionError(f"{tag}: non-finite loss {r['logged'][-1]}")
        if r["saved"] != ([] if r["rank"] else ["model_final.tmp", "model_final_params.tmp"]):
            raise AssertionError(f"{tag}: wrote {r['saved']} (rank 0 writes model_final and "
                                 "model_final_params once, the others nothing)")
        if len(r["allreduce_ms"]) != steps:
            raise AssertionError(f"{tag}: {len(r['allreduce_ms'])} gradient all-reduces in "
                                 f"{steps} steps")
    if len({r["digest"] for r in ranks}) != 1:
        raise AssertionError(f"{name}: the ranks' parameters and EMA differ after the last "
                             f"step: {[r['digest'][:12] for r in ranks]}")
    if not skip_test:
        metrics = ranks[0]["metrics"]
        if set(metrics) != VIDSTG_METRIC_KEYS or not all(np.isfinite(list(metrics.values()))):
            raise AssertionError(f"{name}: test printed {sorted(metrics)}")
        if any(r["metrics"] != metrics for r in ranks):
            raise AssertionError(f"{name}: the merged metrics differ between ranks")
    return {k: sum(r["fit_launches"][k] + (0 if skip_test else r["test_launches"][k])
                   for r in ranks) for k in want_fit}


def _ddp_line(ranks, name, card):
    r0 = ranks[0]
    steps = [r["s_step"] for r in ranks]
    ar = [statistics.median(r["allreduce_ms"]) for r in ranks]
    print(f"train_ddp {name}, world {len(ranks)} (configs/grounding_vidstg.yaml, f32 64f@420, "
          f"V = 1 per rank): s/step per rank {[round(s, 3) for s in steps]} ("
          + (f"steps 2 to {r0['max_iter'] - 1}, synchronised at the ends" if r0["max_iter"] > 2
             else "the profiled last step") + "); gradient all-reduce "
          f"per step (CUDA events around average_gradients, median per rank) "
          f"{[round(x, 3) for x in ar]} ms; bytes all-reduced per step "
          f"{r0['allreduce_bytes'][0]} (+ 8 for the loss's counts); rank 0's profiled last step: "
          f"busy {r0['profiled_busy_ms']:.1f} of {r0['profiled_wall_ms']:.1f} ms, idle share "
          f"{r0['idle_share']:.3f} ({r0['profiled_kernels']} kernels, its own only); peak GiB "
          f"per rank {[round(r['peak_gb'], 2) for r in ranks]} (train "
          f"{[round(r['train_peak_gb'], 2) for r in ranks]}); devices "
          f"{[r['device'] for r in ranks]}  [{card}]")


def run_nccl(world, yaml_path, common, root):
    """The train tool over NCCL at ``world`` ranks, one card each: at world
    size 1, 3 steps (DATA_TRUNK 3, no test; the rendezvous, the warm-up and
    the all-reduces); above, 2 epochs of the 8 train items and the merged
    test. Returns ((results, name, steps), seconds)."""
    opts = common + ["OUTPUT_DIR", tempfile.mkdtemp(prefix=f"nccl{world}_", dir=root)]
    if world == 1:
        opts, steps = opts + ["DATA_TRUNK", "3"], 3
    else:
        opts, steps = opts + ["SOLVER.MAX_EPOCH", "2"], 2 * -(-8 // world)
    t0 = time.perf_counter()
    ranks = run_ranks(world, "nccl", None, {"yaml": yaml_path, "compare": False,
                                            "skip_test": world == 1, "opts": opts})
    return (ranks, "nccl", steps), time.perf_counter() - t0


def train_ddp(dev, card):
    """Data-parallel training over the VidSTG data path, as ``python -m
    torch.distributed.run --nproc_per_node N -m vgqa_tpu_torch.tools.train``
    runs it: configs/grounding_vidstg.yaml as the file leaves it (float32,
    64f@420, 8 loader threads, random weights from seed 0) over
    :func:`write_vidstg_set`'s set (frames from the renderer), each rank a
    spawned process that sets the ``VGQA_*`` contract, joins the group and
    calls ``tools.train.main``.

    1. Two ranks on card 0 over gloo (NCCL takes one rank per card): first
       one dropout-free step from the seeded weights, each rank on its own
       synthetic video; then the train tool: 4 steps at a global batch of 2
       (8 items), ``test`` on the 4 test items, merged. Checks: exact K1 /
       K3 launches per step and K1 / K2 per eval half-pass on every rank, a
       finite loss, the ranks' parameters and EMA bit-equal after the last
       step, ``model_final`` and ``model_final_params`` written once (rank
       0), the merged metrics equal on both ranks with the evaluate tool's
       18 keys, and the first step's loss and gradient norm (the group's
       mean) within 1e-4 (relative) of one process's step on both videos
       as V = 2 from the same weights. Two ranks sharing one card is no
       scaling figure.
    2. NCCL on min(cards, 4) cards (:func:`run_nccl`): on one card, world
       size 1 for 3 steps (no test): the rendezvous, the warm-up and the
       all-reduces; on more, 2 epochs and the merged test, with the checks
       of 1 but the comparison.
    Prints s/step per rank, the gradient all-reduce's ms per step (CUDA
    events), the bytes all-reduced per step, rank 0's idle share over its
    profiled last step and the peak GiB per rank."""
    from vgqa_tpu_torch.config import build_default_cfg

    here = os.path.dirname(os.path.abspath(__file__))
    yaml_path = os.path.join(here, "configs", "grounding_vidstg.yaml")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ddp_", dir=here) as root:
        data = os.path.join(root, "data")
        write_vidstg_set(data)
        common = ["DATA_DIR", data, "TENSORBOARD_DIR", ""]
        t0 = time.perf_counter()
        gloo = run_ranks(DDP_WORLD, "gloo", "cuda:0", {
            "yaml": yaml_path, "compare": True, "skip_test": False,
            "opts": common + ["OUTPUT_DIR", os.path.join(root, "gloo")]})
        gloo_s = time.perf_counter() - t0
        launches = _check_ddp_run(gloo, "gloo", 4, 4, skip_test=False)
        _ddp_line(gloo, "gloo, 2 ranks sharing card 0 (no scaling figure)", card)
        print(f"train_ddp gloo: {gloo_s:.1f} s for both ranks' set-up, comparison step, 4 "
              f"steps, test and checkpoints; test {gloo[0]['test_s']:.1f} s (2 items per rank, "
              f"merged); metrics (random weights, equal on both ranks): "
              f"{json.dumps(gloo[0]['metrics'])}")

        cards = torch.cuda.device_count()
        nccl, nccl_s = run_nccl(min(cards, 4), yaml_path, common, root)
        nccl_launches = _check_ddp_run(*nccl, 4, skip_test=len(nccl[0]) == 1)
        _ddp_line(nccl[0], f"nccl on {len(nccl[0])} of {cards} card(s)", card)
        print(f"train_ddp nccl ran at world size {len(nccl[0])} ({cards} card(s) visible): "
              f"{nccl_s:.1f} s")

    cfg = build_default_cfg()
    cfg.merge_from_file(yaml_path)
    cfg.merge_from_list(["MODEL.VSTG.DROPOUT", "0.0", "TENSORBOARD_DIR", "", "OUTPUT_DIR", ""])
    cfg.freeze()
    single = ddp_first_step(cfg, dev, list(range(DDP_WORLD)))
    group = gloo[0]["first_step"]
    rel = {k: abs(group[k] - single[k]) / max(abs(single[k]), 1e-30)
           for k in ("loss", "grad_norm")}
    print(f"train_ddp first step, dropout off: 2 gloo ranks (V = 1 each, the group's mean) "
          f"loss {group['loss']:.6f}, grad norm {group['grad_norm']:.6f}; one process V = 2 "
          f"loss {single['loss']:.6f}, grad norm {single['grad_norm']:.6f}; relative "
          f"differences {rel['loss']:.2e} / {rel['grad_norm']:.2e} (limit 1e-4)  [{card}]")
    if any(gloo[1]["first_step"][k] != group[k] for k in ("loss", "grad_norm")):
        raise AssertionError("the first step's group mean differs between the ranks")
    if max(rel.values()) > 1e-4:
        raise AssertionError(f"dp = 2 first step vs one process V = 2: {rel}")
    return {"gloo": gloo, "nccl": nccl[0], "nccl_world": len(nccl[0]), "rel": rel,
            "launches": {k: launches[k] + nccl_launches[k] for k in launches}}


def qa_row(name, replaces, launches, unit_rows, repeat, all_rows):
    """One kernel-table entry of a QA kernel: ms / plain / bound / library
    summed over ``unit_rows`` (the calls of one unit of work) x ``repeat``."""
    def total(key):
        return repeat * sum(r[key] for r in unit_rows)

    return {"name": name, "route": "cuda",
            "source": {"int4_matmul": "vgqa_tpu_torch/csrc/int4_matmul.cu",
                       "flash_mha": "vgqa_tpu_torch/csrc/flash_mha_sm90.cu",
                       "flash_gqa_causal": "vgqa_tpu_torch/csrc/flash_gqa_sm90.cu"}[name],
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": {"serve": 0, "train": 0, "qa": launches[name]},
            "max_abs_err": max(r["max_abs_err"] for r in all_rows if r["max_abs_err"] is not None),
            "ms": total("ms"), "plain_ms": total("plain_ms"), "bound_ms": total("bound_ms"),
            "bound_by": max(unit_rows, key=lambda r: r["bound_ms"])["bound_by"],
            "library_ms": total("library_ms")}


def serve_qa(dev, card):
    """Video QA at the full InternVideo2.5-Chat-8B geometry, bf16 then int4."""
    from vgqa_tpu_torch.qa import LLMConfig, QAEngine, ViTConfig
    from vgqa_tpu_torch.qa.engine import GenerationConfig
    from vgqa_tpu_torch.qa.quant import linear_forms, quantize_llm_params_int4
    from vgqa_tpu_torch.utils import trace

    llm_cfg, vit_cfg = LLMConfig.internlm2_5_7b(), ViTConfig.internvit_300m()
    t0 = time.perf_counter()
    eng = QAEngine.init_random(llm_cfg, vit_cfg, seed=0, device=dev, dtype=torch.bfloat16,
                               max_seq_len=9216)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for m in (eng.llm, eng.embed, eng.vision) for p in m.parameters())
    print(f"QA engine built in {time.perf_counter() - t0:.1f} s: {n_params / 1e9:.3f}B params "
          f"bf16, max_seq_len {eng.max_seq_len}")
    frames = 32
    npl = [1] * frames
    tiles = np.random.RandomState(0).randint(0, 256, (frames, 448, 448, 3), np.uint8)
    question = "What is happening in this video? Describe the main events in order."
    ids, _ = eng.build_prompt_ids(question, npl)
    Lp, chunked = eng._plan_prefill(len(ids))
    chunks = Lp // eng.PREFILL_CHUNK
    vis_chunks = -(-frames // eng.vision_chunk)
    print(f"prompt {len(ids)} tokens -> prefill Lp {Lp}, chunked {chunked} ({chunks} chunks), "
          f"{vis_chunks} vision chunks of {eng.vision_chunk} tiles")
    if not (chunked and chunks == QA_CHUNKS):
        raise AssertionError("the 32-frame prompt should prefill in 9 chunks of 1024")
    greedy = GenerationConfig(max_new_tokens=32, do_sample=False, ignore_eos=True)
    per_chat = {"flash_mha": 24 * vis_chunks, "flash_gqa_causal": 32 * chunks}
    zero = {n: 0 for n in ("swin_block_canvas", "swin_block_fused", "window_attention",
                           "flash_mha_train.fwd", "flash_mha_train.bwd")}

    t0 = time.perf_counter()
    eng.chat(tiles, question, greedy, num_patches_list=npl)
    torch.cuda.synchronize()
    print(f"QA warm-up chat: {time.perf_counter() - t0:.2f} s")

    runs, total = {}, {"flash_mha": 0, "flash_gqa_causal": 0, "int4_matmul": 0}

    def timed_chat(name, expect_int4_per_fwd, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        text, st = eng.chat(tiles, question, kw.pop("gen", greedy), num_patches_list=npl,
                            return_stats=True, **kw)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        fwd = max(st["decode_tokens"] - 1, 0)
        want = dict(zero, **per_chat, int4_matmul=expect_int4_per_fwd * fwd)
        print(f"QA chat [{name}]: vision {st['vision_s']:.3f} s, prefill {st['prefill_s']:.3f} s "
              f"({st['prefill_tok_s']:.0f} tok/s, {st['prefill_tokens']} tokens), decode "
              f"{st['decode_s']:.3f} s ({st['decode_tok_s']:.2f} tok/s, {st['decode_tokens']} "
              f"tokens, {fwd} decode forwards), peak {peak:.2f} GiB  [{card}]")
        print(f"  launches {launches}; answer {text[:60]!r}")
        if not isinstance(text, str) or not all(
                np.isfinite(v) for v in st.values() if isinstance(v, float)):
            raise AssertionError(f"QA chat [{name}]: bad answer or stats {st}")
        if launches != want:
            raise AssertionError(f"QA chat [{name}]: launches {launches}, expected {want}")
        for n in total:
            total[n] += launches[n]
        runs[name] = dict(st, peak_gb=peak, launches=launches, decode_forwards=fwd)

    def routes_vs_plain(name):
        on = eng.prefill_logits(tiles, question, npl).float()
        eng.use_kernels = False
        off = eng.prefill_logits(tiles, question, npl).float()
        eng.use_kernels = True
        rel = float((on - off).abs().max() / off.abs().max())
        agree = bool(on.argmax() == off.argmax())
        print(f"QA last-prompt-token logits, kernel vs plain routes [{name}]: rel err {rel:.3e}, "
              f"argmax agrees {agree}")
        # bf16 through 32 layers with random weights: the routes round at
        # other points; a broken kernel moves the logits by far more
        if not (np.isfinite(rel) and rel < 5e-2):
            raise AssertionError(f"QA [{name}]: kernel and plain routes disagree ({rel})")
        return rel

    def profile_decode(name, compare=False):
        """One decode step (B = 1, int8 KV cache of the 32-frame prompt)
        under torch.profiler: wall, device busy, launches, top kernels. With
        ``compare``, the step's logits with kernel routes on (K6 for the
        int4 products) against the plain routes (the half-matmul form), from
        the same cache; each step rewrites only its own position."""
        vt = eng._encode_vision(tiles).reshape(-1, llm_cfg.hidden_size)
        ids, img_pos = eng.build_prompt_ids(question, npl)
        embeds = eng._embed_prompt(ids, img_pos, vt, Lp)
        logits, cache = eng._prefill(embeds, len(ids), Lp, True, Lp + greedy.max_new_tokens)
        token = logits.argmax(-1)
        out = {}
        with torch.no_grad():
            step = (lambda: eng._decode_impl(cache, token, len(ids)))
            step()
            wall, busy, n_kernels, top = profile_step(step)
            if compare:
                counts = {}
                for on in (True, False):
                    eng.use_kernels = on
                    before = read_launches()["int4_matmul"]
                    out[on] = step()[0].float()
                    counts[on] = read_launches()["int4_matmul"] - before
                eng.use_kernels = True
        print(f"QA decode step [{name}] under the profiler: wall {wall:.1f} ms, device busy "
              f"{busy:.1f} ms (idle share {1 - busy / wall:.3f}), {n_kernels} kernel launches")
        for kname, us in top[:8]:
            print(f"  {us / 1e3:8.3f} ms  {kname[:110]}")
        del cache
        res = {"wall_ms": wall, "busy_ms": busy, "kernels": n_kernels}
        if compare:
            rel = float((out[True] - out[False]).abs().max() / out[False].abs().max())
            agree = bool(out[True].argmax() == out[False].argmax())
            print(f"QA decode-step logits, kernel vs plain routes [{name}]: rel err {rel:.3e}, "
                  f"argmax agrees {agree}, K6 launches {counts[True]} on / {counts[False]} off")
            if counts != {True: 7 * llm_cfg.num_layers, False: 0}:
                raise AssertionError(f"QA decode step [{name}]: K6 launches {counts}")
            if not (np.isfinite(rel) and rel < 5e-2):
                raise AssertionError(f"QA decode step [{name}]: kernel and plain routes "
                                     f"disagree ({rel})")
            res["rel_routes"] = rel
        return res

    reset_launches()
    timed_chat("bf16 greedy", 0)
    prof = {"bf16": profile_decode("bf16")}
    rel_bf16 = routes_vs_plain("bf16")
    gc.collect()
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    quantize_llm_params_int4(eng.llm)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    print(f"int4 quantization on the device: {time.perf_counter() - t0:.2f} s, forms "
          f"{linear_forms(eng.llm)}, allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    timed_chat("int4 greedy", 7 * llm_cfg.num_layers)
    prof["int4"] = profile_decode("int4", compare=True)
    rel_int4 = routes_vs_plain("int4")
    sampled = GenerationConfig(max_new_tokens=32, temperature=0.2, top_p=0.9, ignore_eos=True)
    timed_chat("int4 sampled", 7 * llm_cfg.num_layers, gen=sampled,
               generator=torch.Generator(device=dev).manual_seed(0))

    tiles2 = np.random.RandomState(1).randint(0, 256, (frames, 448, 448, 3), np.uint8)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with trace.tracing():
        answers = eng.chat_batch([(tiles, question, npl), (tiles2, "Who is in the video?", npl)],
                                 gen=greedy)
        decode = trace.snapshot()["counters"]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    # the host calls K6's wrapper in every eager forward and in the capture
    # of the decode graph, whose replays launch it without the host
    host_forwards = (decode["qa.decode.forwards"] - decode.get("qa.decode.graph_replays", 0)
                     + decode.get("qa.decode.graph_captures", 0))
    if decode["qa.decode.forwards"] != greedy.max_new_tokens - 1:
        raise AssertionError(f"chat_batch decode counters {decode}")
    want = dict(zero, flash_mha=2 * per_chat["flash_mha"],
                flash_gqa_causal=2 * per_chat["flash_gqa_causal"],
                int4_matmul=7 * llm_cfg.num_layers * host_forwards)
    print(f"QA chat_batch of 2 [int4 greedy]: {dt:.3f} s, {2 * greedy.max_new_tokens / dt:.2f} tok/s "
          f"aggregate end to end, peak {peak:.2f} GiB  [{card}]")
    print(f"  launches {launches}; decode counters {decode}; answers "
          f"{[a[:30] for a in answers]!r}")
    if not (len(answers) == 2 and all(isinstance(a, str) for a in answers)):
        raise AssertionError(f"chat_batch answers {answers!r}")
    if launches != want:
        raise AssertionError(f"chat_batch launches {launches}, expected {want}")
    for n in total:
        total[n] += launches[n]
    runs["int4 batch"] = {"total_s": dt, "peak_gb": peak, "launches": launches}
    del eng
    return {"runs": runs, "launches": total, "rel_bf16": rel_bf16, "rel_int4": rel_int4,
            "rel_int4_decode": prof["int4"]["rel_routes"], "decode_profile": prof,
            "per_chat": per_chat}


HTTP_VIDEOS = 4                      # placeholder files the HTTP phase serves
HTTP_VIDEO_INFO = (200, 25.0, 640, 360)   # frames, fps, width, height of each
HTTP_MAX_TOKENS = 16
HTTP_POLICY_ROUNDS = 12              # bursts of 4 /api/predict per grounding policy


def _http(base, path, body=None, timeout=900):
    """(status, JSON body) of one request to the server under test (an error
    status comes back, not raised)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(base + path, method="POST" if body is not None else "GET",
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _burst(coalescer, send, n):
    """Send ``n`` requests concurrently, all queued before the server's drain
    thread starts (held back as if a batch were running), so it drains them
    in batches of its ``max_batch``. Returns (results, wall s from the first
    send to the last answer)."""
    import threading

    for _ in range(1000):                  # the previous burst's drain has ended
        with coalescer._mutex:
            if not coalescer._alive:
                coalescer._alive = True
                break
        time.sleep(0.01)
    else:
        raise AssertionError("the server's drain thread did not end")
    results = [None] * n
    t0 = time.perf_counter()
    threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, send(i)))
               for i in range(n)]
    for t in threads:
        t.start()
    deadline = time.perf_counter() + 120
    while True:
        with coalescer._mutex:
            queued = len(coalescer._jobs)
        if queued == n:
            break
        if time.perf_counter() > deadline:      # a request failed before it queued
            threading.Thread(target=coalescer._drain_loop, daemon=True).start()
            for t in threads:
                t.join()
            raise AssertionError(f"{queued} of {n} requests queued: {results}")
        time.sleep(0.002)
    threading.Thread(target=coalescer._drain_loop, daemon=True).start()
    for t in threads:
        t.join()
    return results, time.perf_counter() - t0


def _concurrent(send, n):
    """``n`` requests sent together from ``n`` threads: (results, each
    one's latency s, wall s from the first send to the last answer)."""
    import threading

    results, lat = [None] * n, [0.0] * n

    def one(i):
        t = time.perf_counter()
        results[i] = send(i)
        lat[i] = time.perf_counter() - t

    threads = [threading.Thread(target=one, args=(i,)) for i in range(n)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return results, lat, time.perf_counter() - t0


def _policy_rounds(server, predict, names, card):
    """The two grounding policies on the server's coalescer as it runs (the
    first request of a burst starts a drain, which takes what is queued by
    then, up to ``max_batch``): ``HTTP_POLICY_ROUNDS`` bursts of 4
    concurrent /api/predict per policy, interleaved ABBA, then one more
    burst per policy under the profiler (CUDA activity only) for the
    device's busy time (union of its kernel and copy intervals) and idle
    share. Each burst's answers are checked, and its K1 / K2 launches
    against the batches the drain made (pipelined: a forward per video;
    coalesced: one per batch). The drain's batch sizes are read through a
    counting wrapper of the coalescer's runner, which changes nothing
    else."""
    from torch.profiler import ProfilerActivity, profile

    coalescer = server._ground_coalescer
    run_batch, sizes = coalescer.run_batch, []

    def counted(requests):
        sizes.append(len(requests))
        return run_batch(requests)

    def burst(policy):
        server.GROUND_COALESCE = policy == "coalesced"
        sizes.clear()
        reset_launches()
        res, lat, wall = _concurrent(predict, 4)
        launches = read_launches()
        for i, (status, body) in enumerate(res):
            _check_predict(status, body, names[i % len(names)])
        fwds = sum(sizes) if policy == "pipelined" else len(sizes)
        want = {n: 0 for n in launches}
        want.update(swin_block_canvas=12 * fwds, window_attention=6 * fwds)
        if sum(sizes) != 4 or launches != want:
            raise AssertionError(f"/api/predict {policy} round: batches {sizes}, launches "
                                 f"{launches}, expected {want}")
        return lat, wall, list(sizes), launches

    out = {p: {"walls": [], "latencies": [], "batches": []} for p in ("pipelined", "coalesced")}
    total = {}
    coalescer.run_batch = counted
    try:
        for r in range(HTTP_POLICY_ROUNDS):
            for policy in (("pipelined", "coalesced") if r % 2 == 0
                           else ("coalesced", "pipelined")):
                lat, wall, batches, launches = burst(policy)
                out[policy]["walls"].append(wall)
                out[policy]["latencies"].extend(lat)
                out[policy]["batches"].append(batches)
                for k, v in launches.items():
                    total[k] = total.get(k, 0) + v
        for policy, o in out.items():
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                lat, wall, batches, launches = burst(policy)
            for k, v in launches.items():
                total[k] = total.get(k, 0) + v
            spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA)
            busy, end = 0.0, -1.0
            for a, b in spans:
                if b > end:
                    busy += b - max(a, end)
                    end = b
            o["profiled"] = ({"wall_s": wall, "busy_s": busy / 1e6,
                              "idle_share": 1 - busy / 1e6 / wall, "device_events": len(spans),
                              "batches": batches} if spans else None)
    finally:
        coalescer.run_batch = run_batch
    for policy, o in out.items():
        w, lat = sorted(o["walls"]), sorted(o["latencies"])
        med = statistics.median(w)
        o.update(median_wall_s=med, min_wall_s=w[0], max_wall_s=w[-1],
                 clips_per_s=8 / med, inverse_throughput_s=med / 4,
                 median_latency_s=statistics.median(lat), max_latency_s=lat[-1])
        prof = o["profiled"]
        idle = ("not measured (the profiler saw no device event)" if prof is None else
                f"{prof['busy_s']:.3f} s busy of a {prof['wall_s']:.3f} s profiled burst, "
                f"idle share {prof['idle_share']:.3f} (batches {prof['batches']})")
        print(f"serve_http /api/predict policy rounds, {policy}: {HTTP_POLICY_ROUNDS} bursts of 4 "
              f"concurrent requests on the server's own coalescer; wall per burst median "
              f"{med:.4f} s (min {w[0]:.4f}, max {w[-1]:.4f}; all {[round(x, 4) for x in o['walls']]})"
              f", {8 / med:.2f} clips/s at the median, inverse throughput {med / 4:.4f} s per "
              f"request; request latency median {o['median_latency_s']:.4f} s, max "
              f"{lat[-1]:.4f} s; drain batches {o['batches']}; device {idle}  [{card}]")
    out["launches"] = total
    return out


def _check_predict(status, body, name):
    if status != 200:
        raise AssertionError(f"/api/predict {name}: {status} {body}")
    if body["video"] != {"name": name, "url": f"/videos/{name}"}:
        raise AssertionError(f"/api/predict video {body['video']}")
    if body["meta"] != dict(zip(("total_frames", "fps", "width", "height"), HTTP_VIDEO_INFO)):
        raise AssertionError(f"/api/predict meta {body['meta']}")
    if set(body["result"]) != {"temporal", "tube"}:
        raise AssertionError(f"/api/predict result keys {sorted(body['result'])}")
    check_response(body["result"], HTTP_VIDEO_INFO[0])


def serve_http(dev, card, config_path=None, llm_cfg=None, vit_cfg=None):
    """The port's web app at full width: ``vgqa_tpu_torch.app.server`` in this
    process on an ephemeral port, on the card, with
    configs/grounding_vidstg.yaml as the file leaves it (420 px, 2 x 64
    frames, bf16 serving, random weights from seed 0) and QA from a model
    directory that holds only the InternLM2.5-7B / InternViT-300M geometry
    (bf16, random weights, the 8,192-token context ``_load_engine`` keeps).
    The machine has no video decoder, so the served videos are placeholder
    files whose frames come from the synthetic renderer: ``video_info``,
    ``read_frames`` and ``read_frames_yuv`` (grounding, /api/meta) and the QA
    tile loaders are replaced here; everything after the decode is the
    port's. Traffic: GET health / videos / meta; 4 concurrent /api/predict
    queued before the drain starts, pipelined (drained as pairs: 4 V = 2
    forwards) and again with VGQA_GROUND_COALESCE=1 (2 V = 4 forwards: the
    V = 4 peak and the responses' agreement); both policies again on the
    coalescer as it runs (``_policy_rounds``: the times); 2 concurrent /api/qa at the
    largest frame count whose prompt and answer fit the context (one
    chat_batch); one /api/qa at 32 frames (500, the context error, in its
    own slot); one /api/generate-queries. Checks statuses, schemas, exact
    K1 / K2 / K4 / K5 launches, and the coalesced responses against the
    pipelined ones within ``serve``'s route limits. ``config_path`` /
    ``llm_cfg`` / ``vit_cfg`` replace the full-width models (a small dry run
    of the phase's code)."""
    from vgqa_tpu_torch.app import server
    from vgqa_tpu_torch.data import video_io
    from vgqa_tpu_torch.data.synthetic import frame_reader
    from vgqa_tpu_torch.inference import grounding, qa
    from vgqa_tpu_torch.qa import LLMConfig, QAEngine, ViTConfig
    from vgqa_tpu_torch.qa.llm import LLM, TokenEmbedding
    from vgqa_tpu_torch.qa.vit import VisionTower

    from vgqa_tpu_torch.config import build_default_cfg

    here = os.path.dirname(os.path.abspath(__file__))
    config_path = config_path or os.path.join(here, "configs", "grounding_vidstg.yaml")
    cfg = build_default_cfg()
    cfg.merge_from_file(config_path)
    res = cfg.INPUT.RESOLUTION
    total, fps, _, _ = HTTP_VIDEO_INFO
    names = [f"http_vid{i:03d}.mp4" for i in range(HTTP_VIDEOS)]
    llm_cfg = llm_cfg or LLMConfig.internlm2_5_7b()
    vit_cfg = vit_cfg or ViTConfig.internvit_300m()
    readers = {}

    def read_frames(path, ids, *args, size=None, **kwargs):
        return readers[size](path, ids)

    def video_tiles(path, bound=None, input_size=448, max_num=1, num_segments=32):
        input_size = vit_cfg.image_size if input_size == 448 else input_size  # as _load_tiles
        ids = np.clip(video_io.frame_indices_with_bound(bound, fps, total - 1, num_segments),
                      0, total - 1)
        return read_frames(path, ids, size=(input_size, input_size)), [1] * len(ids)

    real = {(video_io, "video_info"): video_io.video_info,
            (grounding, "video_info"): grounding.video_info,
            (grounding, "read_frames"): grounding.read_frames,
            (grounding, "read_frames_yuv"): grounding.read_frames_yuv,
            (qa, "load_video_tiles"): qa.load_video_tiles,
            (qa, "load_video_tiles_yuv"): qa.load_video_tiles_yuv}
    saved = {k: getattr(server, k) for k in ("VIDEOS_ROOT", "GROUNDING_CONFIG",
                                             "GROUNDING_CKPT", "QA_MODEL_DIR", "DEVICE",
                                             "GROUND_COALESCE")}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_http_", dir=here) as root:
        for name in names:
            with open(os.path.join(root, name), "wb") as f:
                f.write(bytes(4096))
        qa_dir = os.path.join(root, "qa")
        os.makedirs(qa_dir)
        with open(os.path.join(qa_dir, "vgqa_tpu_config.json"), "w") as f:
            json.dump({"llm": dataclasses.asdict(llm_cfg), "vit": dataclasses.asdict(vit_cfg)}, f)
        t0 = time.perf_counter()
        for size in ((res, res), (vit_cfg.image_size, vit_cfg.image_size)):
            readers[size] = frame_reader(total, size, seed=0)
            for name in names:                       # render in set-up
                readers[size](name, [0])
        print(f"serve_http: no video decoder on this machine: the {HTTP_VIDEOS} placeholder "
              f"videos ({total} frames, {fps} fps, 640x360) are served from the synthetic "
              "renderer (data/synthetic.frame_reader, at the decode size), replacing "
              "video_info, read_frames, read_frames_yuv and the QA tile loaders; rendered in "
              f"{time.perf_counter() - t0:.1f} s")
        for (mod, attr) in real:
            setattr(mod, attr, {"video_info": lambda path: HTTP_VIDEO_INFO,
                                "read_frames": read_frames,
                                "read_frames_yuv": lambda *a, **kw: None,
                                "load_video_tiles": video_tiles,
                                "load_video_tiles_yuv": lambda *a, **kw: None}[attr])
        server.VIDEOS_ROOT = server.Path(root).resolve()
        server.GROUNDING_CONFIG = config_path
        server.GROUNDING_CKPT = ""
        server.QA_MODEL_DIR = qa_dir
        server.DEVICE = None if dev.type == "cuda" else str(dev)       # None: the card
        srv = server.make_server(0, "127.0.0.1")
        import threading

        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            out = _serve_http_traffic(base, server, cfg, names, llm_cfg, vit_cfg,
                                      (QAEngine, LLM, TokenEmbedding, VisionTower), card)
        finally:
            srv.shutdown()
            srv.server_close()
            for (mod, attr), fn in real.items():
                setattr(mod, attr, fn)
            for k, v in saved.items():
                setattr(server, k, v)
            grounding._load_cached.cache_clear()
            qa._load_cached.cache_clear()
    return out


def _serve_http_traffic(base, server, cfg, names, llm_cfg, vit_cfg, qa_mods, card):
    QAEngine, LLM, TokenEmbedding, VisionTower = qa_mods
    px = cfg.INPUT.RESOLUTION
    walls = {}
    for path, want in (("/api/health", {"ok": True}),
                       ("/api/videos", {"directory": str(server.VIDEOS_ROOT), "files": names}),
                       ("/api/meta?video=" + names[0],
                        dict(zip(("total_frames", "fps", "width", "height"), HTTP_VIDEO_INFO)))):
        t0 = time.perf_counter()
        status, body = _http(base, path)
        walls[path.split("?")[0]] = time.perf_counter() - t0
        if (status, body) != (200, want):
            raise AssertionError(f"GET {path}: {status} {body}")

    # ---- grounding: warm-up, then 4 concurrent requests per policy ---------
    def predict(i):
        return _http(base, "/api/predict", {"video": names[i % len(names)],
                                            "query": f"the person in red walks to the car {i}"})

    t0 = time.perf_counter()
    for coalesce in (False, True):         # the model (built on the first), each forward shape
        server.GROUND_COALESCE = coalesce  # the server's reading of VGQA_GROUND_COALESCE
        res, _ = _burst(server._ground_coalescer, predict, 2)
        for i, (status, body) in enumerate(res):
            _check_predict(status, body, names[i])
    torch.cuda.synchronize()
    print(f"serve_http: grounding model built and warmed (one pair per policy) in "
          f"{time.perf_counter() - t0:.1f} s")
    runs = {}
    for policy, coalesce, per_fwd in (("pipelined", False, 2), ("coalesced", True, 4)):
        server.GROUND_COALESCE = coalesce
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        res, wall = _burst(server._ground_coalescer, predict, 4)
        torch.cuda.synchronize()
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        for i, (status, body) in enumerate(res):
            _check_predict(status, body, names[i % len(names)])
        fwds = 4 * 2 // per_fwd
        want = {n: 0 for n in launches}
        want.update(swin_block_canvas=12 * fwds, window_attention=6 * fwds)
        if launches != want:
            raise AssertionError(f"/api/predict {policy}: launches {launches}, expected {want} "
                                 f"({fwds} forwards of V = {per_fwd})")
        runs[policy] = {"wall_s": wall, "forwards": fwds, "rows_per_forward": per_fwd,
                        "peak_gb": peak, "launches": launches,
                        "results": [b["result"] for _, b in res]}
        print(f"serve_http /api/predict x4 queued as pairs, {policy} ({fwds} forwards of V = "
              f"{per_fwd}, {px} px, {2 * cfg.INPUT.TRAIN_SAMPLE_NUM} frames each): wall "
              f"{wall:.3f} s (one burst: times are the policy rounds' below), peak "
              f"{peak:.2f} GiB; launches K1 "
              f"{launches['swin_block_canvas']} K2 {launches['window_attention']}  [{card}]")
    box = att = 0.0
    spans = []
    for a, b in zip(runs["coalesced"]["results"], runs["pipelined"]["results"]):
        if [e["frame"] for e in a["tube"]] != [e["frame"] for e in b["tube"]]:
            raise AssertionError("coalesced and pipelined tubes cover other frames")
        box = max(box, float(np.abs(np.asarray([e["bbox"] for e in a["tube"]])
                                    - np.asarray([e["bbox"] for e in b["tube"]])).max()))
        att = max(att, float(np.abs(np.asarray([e["score"] for e in a["tube"]])
                                    - np.asarray([e["score"] for e in b["tube"]])).max()))
        spans.append(((a["temporal"]["start"], a["temporal"]["end"]),
                      (b["temporal"]["start"], b["temporal"]["end"])))
    print(f"serve_http coalesced vs pipelined responses (4 requests): max |d box| {box:.3f} px "
          f"(of 640x360), max |d score| {att:.4f}, spans (coalesced, pipelined) {spans}")
    # serve's route limits: bf16 rounding over 40-odd layers moves boxes by a
    # few pixels; a wrong row merge moves them by hundreds
    if not (np.isfinite(box) and box < 64.0 and att < 0.1):
        raise AssertionError("coalesced and pipelined responses disagree")
    rounds = _policy_rounds(server, predict, names, card)

    # ---- QA: the frame count that fits the context, counted on a meta engine
    with torch.device("meta"):
        probe = QAEngine(llm_cfg, vit_cfg, LLM(llm_cfg), TokenEmbedding(llm_cfg),
                         VisionTower(vit_cfg))

    def fits(question):
        return max(n for n in range(1, 33)
                   if len(probe.build_prompt_ids(question, [1] * n)[0]) + HTTP_MAX_TOKENS
                   <= probe.max_seq_len)

    def launches_of(n, question):
        """(K4, K5) launches of one request: 24 per vision chunk, 32 per
        prefill chunk."""
        lp, chunked = probe._plan_prefill(len(probe.build_prompt_ids(question, [1] * n)[0]))
        return 24 * -(-n // probe.vision_chunk), 32 * (lp // probe.PREFILL_CHUNK if chunked else 1)

    questions = ["What is happening in this video?", "Who is in the video, and what do they do?"]
    gen_question = server.generate_queries_question(5)
    n_qa = min(fits(q) for q in questions)
    n_gen = fits(gen_question)
    want_qa = [launches_of(n_qa, q) for q in questions]
    want_gen = launches_of(n_gen, gen_question)
    context = probe.max_seq_len
    del probe
    print(f"serve_http QA frames: {n_qa} for /api/qa, {n_gen} for /api/generate-queries (the "
          f"largest counts whose prompt + {HTTP_MAX_TOKENS} answer tokens fit the {context}-token "
          "context)")

    def qa_body(i, n, question):
        return {"video": names[i], "question": question, "num_frames": n,
                "max_tokens": HTTP_MAX_TOKENS}

    t0 = time.perf_counter()
    status, body = _http(base, "/api/qa", qa_body(0, 4, questions[0]))
    torch.cuda.synchronize()
    if status != 200 or set(body) != {"answer"}:
        raise AssertionError(f"/api/qa warm-up: {status} {body}")
    print(f"serve_http: QA engine built (bf16, random weights) and warmed by a 4-frame "
          f"request in {time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    res, wall = _burst(server._qa_coalescer, lambda i: _http(
        base, "/api/qa", qa_body(i, n_qa, questions[i])), 2)
    torch.cuda.synchronize()
    qa_launches = read_launches()
    qa_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for status, body in res:
        if status != 200 or set(body) != {"answer"} or not isinstance(body["answer"], str):
            raise AssertionError(f"/api/qa: {status} {body}")
    want = {n: 0 for n in qa_launches}
    want.update(flash_mha=sum(w[0] for w in want_qa), flash_gqa_causal=sum(w[1] for w in want_qa))
    if qa_launches != want:
        raise AssertionError(f"/api/qa x2: launches {qa_launches}, expected {want}")
    walls["/api/qa"] = wall / 2
    print(f"serve_http /api/qa x2 concurrent ({n_qa} frames, one chat_batch, {HTTP_MAX_TOKENS} "
          f"tokens at most): {wall:.3f} s, {wall / 2:.3f} s/request, peak {qa_peak:.2f} GiB; "
          f"launches K4 {qa_launches['flash_mha']} K5 {qa_launches['flash_gqa_causal']}; "
          f"answers {[b['answer'][:20] for _, b in res]!r}  [{card}]")

    t0 = time.perf_counter()
    status, body = _http(base, "/api/qa", qa_body(1, 32, questions[0]))
    walls["/api/qa (32 frames, refused)"] = time.perf_counter() - t0
    if status != 500 or "ValueError: prompt is" not in body.get("detail", "") \
            or f"context is {context}" not in body["detail"]:
        raise AssertionError(f"/api/qa at 32 frames: {status} {body}")
    print(f"serve_http /api/qa at 32 frames: {status} {body['detail']!r}")

    reset_launches()
    t0 = time.perf_counter()
    status, body = _http(base, "/api/generate-queries", {"video": names[2], "num_queries": 5,
                                                         "num_frames": n_gen,
                                                         "max_tokens": HTTP_MAX_TOKENS})
    torch.cuda.synchronize()
    walls["/api/generate-queries"] = time.perf_counter() - t0
    gen_launches = read_launches()
    if status != 200 or set(body) != {"queries", "raw_answer"} \
            or not isinstance(body["queries"], list):
        raise AssertionError(f"/api/generate-queries: {status} {body}")
    want = {n: 0 for n in gen_launches}
    want.update(flash_mha=want_gen[0], flash_gqa_causal=want_gen[1])
    if gen_launches != want:
        raise AssertionError(f"/api/generate-queries: launches {gen_launches}, expected {want}")
    print(f"serve_http /api/generate-queries ({n_gen} frames): {walls['/api/generate-queries']:.3f}"
          f" s; launches K4 {gen_launches['flash_mha']} K5 {gen_launches['flash_gqa_causal']}; "
          f"{len(body['queries'])} queries parsed from {body['raw_answer'][:30]!r}  [{card}]")
    return {"runs": runs, "rounds": rounds, "walls": walls, "qa_launches": qa_launches,
            "gen_launches": gen_launches, "n_qa": n_qa, "n_gen": n_gen, "qa_peak_gb": qa_peak,
            "box_diff": box, "att_diff": att}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}"
          f"  device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    from vgqa_tpu_torch.ops.kernels import build

    t0 = time.perf_counter()
    build.load_library()
    print(f"kernels built+loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_log['seconds']:.2f} s) -> {build.build_log['path']}")
    serialised = []
    for line in build.build_log["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
        if re.search(r"\(C75(11|12|20)\)", line):     # wgmma serialised for lack of registers
            serialised.append(line.strip())
    if serialised:
        raise AssertionError("ptxas serialised wgmma:\n" + "\n".join(serialised))

    g = torch.Generator(device=dev).manual_seed(0)
    with all_f32():       # the kernel-versus-plain checks: f32 plain versions stay f32
        k2_rows = check_window_attention(dev, g)
        k1_rows = check_swin_block(dev, g, K1_SERVE_CASES, batch=2, gated=False)
        k1_train_rows = check_swin_block(dev, g, K1_TRAIN_CASES, batch=1, gated=True)
        k1f_rows = check_swin_fused(dev, g, K1_SERVE_CASES, batch=2)
        k3_rows = check_flash_train(dev, g)
        f32_rows = check_f32_kernels(dev, g)
        k4_rows = check_flash_mha(dev, g)
        k5_rows = check_flash_gqa(dev, g)
        k6_rows = check_int4(dev, g)
        k6_token_ms = int4_token_device_ms(dev, g)
        k6_host_us = int4_host_us(dev, g)
        quant_rows = check_quant_bf16(dev, g)
    torch.cuda.empty_cache()

    # the path phases, each at full width under the entry points' precision
    # policy (a wrapper raises for a shape its kernel does not take)
    def phase(fn):
        out = fn(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        return out

    serve_launches = phase(serve)
    tower = phase(swin_tower_routes)
    tr = phase(train)
    tr420 = phase(train_420)
    tr32 = phase(train_f32)
    vidstg = phase(train_vidstg)
    ddp = phase(train_ddp)
    tr_swin = phase(train_trainable)
    qa = phase(serve_qa)
    http = phase(serve_http)
    qa_l = qa["launches"]
    http_l = {k: sum(run[k] for run in (http["runs"]["pipelined"]["launches"],
                                        http["runs"]["coalesced"]["launches"],
                                        http["rounds"]["launches"],
                                        http["qa_launches"], http["gen_launches"]))
              for k in http["qa_launches"]}
    vl = vidstg["launches"]
    dl = ddp["launches"]

    k1_fwd = sum(r["ms"] * r["per_fwd"] for r in k1_rows)
    k1_plain = sum(r["plain_ms"] * r["per_fwd"] for r in k1_rows)
    k1_bound = sum(r["bound_ms"] * r["per_fwd"] for r in k1_rows)
    k1_by = max(k1_rows, key=lambda r: r["bound_ms"] * r["per_fwd"])["bound_by"]
    k2 = k2_rows[0]
    k3 = next(r for r in k3_rows if r["L"] == 124 and r["rate"] == 0.1)
    k3_lib = next(r for r in k3_rows if r["L"] == 124 and r["rate"] == 0.0)
    k3_420 = next(r for r in k3_rows if r["L"] == 418 and r["rate"] == 0.1)
    k3_launches = {d: tr["launches"][f"flash_mha_train.{d}"]
                   + tr420["launches"][f"flash_mha_train.{d}"]
                   + tr32["launches"][f"flash_mha_train.{d}"]
                   + vl[f"flash_mha_train.{d}"] + dl[f"flash_mha_train.{d}"]
                   for d in ("fwd", "bwd")}
    f32_k1, f32_k2 = f32_rows["k1"], f32_rows["k2"]
    f32_k3 = {r["rate"]: r for r in f32_rows["k3"]}
    k4 = k4_rows[0]
    f32_k1_row = {
        "launches_train_f32": tr32["launches"]["swin_block_canvas"],
        "max_rel_err": max(r["rel_err"] for r in f32_k1),
        "max_abs_err": max(r["max_abs_err"] for r in f32_k1),
        "step_ms": sum(r["ms"] * r["per_step"] for r in f32_k1),
        "step_device_ms": sum(r["device_ms"] * r["per_step"] for r in f32_k1),
        "step_plain_ms": sum(r["plain_ms"] * r["per_step"] for r in f32_k1),
        "step_bound_ms": sum(r["bound_ms"] * r["per_step"] for r in f32_k1),
        "step_ffma_bound_ms": sum(r["ffma_bound_ms"] * r["per_step"] for r in f32_k1),
        "step_gemm_device_ms": sum(r["gemm_device_ms"] * r["per_step"] for r in f32_k1),
        "step_attn_device_ms": sum(r["attn_device_ms"] * r["per_step"] for r in f32_k1),
        "step_ln_device_ms": sum(r["ln_device_ms"] * r["per_step"] for r in f32_k1),
        "in_step_device_ms": tr32["k1_device_ms"]}
    k1_phase = {p: sum(r[f"{p}_device_ms"] * r["per_fwd"] for r in k1_rows)
                for p in ("gemm", "attn", "ln")}
    k1_device = sum(r["device_ms"] * r["per_fwd"] for r in k1_rows)
    k1_floor = sum(r["chain_floor_ms"] * r["per_fwd"] for r in k1_rows)
    print(f"K1 per V=2 forward at 224 px: device {k1_device:.3f} ms = gemm "
          f"{k1_phase['gemm']:.3f} + attn {k1_phase['attn']:.3f} + ln {k1_phase['ln']:.3f}; "
          f"events {k1_fwd:.3f} ms; bound {k1_bound:.3f} ms ({k1_by}), chain byte floor "
          f"{k1_floor:.3f} ms  [{card}]")
    print(f"K1 old vs new: per V=2 forward at 224 px {K1_RECORDED_MS['forward_224']:.2f} ms "
          f"(recorded, the WMMA chain, events) -> {k1_fwd:.3f} ms (events, this run); f32 per "
          f"64f@420 step {K1_RECORDED_MS['f32_step_420']:.1f} ms (recorded) -> "
          f"{f32_k1_row['step_ms']:.3f} ms (events; device {f32_k1_row['step_device_ms']:.3f} "
          f"= gemm {f32_k1_row['step_gemm_device_ms']:.3f} + attn "
          f"{f32_k1_row['step_attn_device_ms']:.3f} + ln {f32_k1_row['step_ln_device_ms']:.3f}; "
          f"3xTF32 bound {f32_k1_row['step_bound_ms']:.3f}, all-FFMA bound "
          f"{f32_k1_row['step_ffma_bound_ms']:.3f})  [{card}]")
    table = {"kernels": [
        {"name": "swin_block_canvas", "route": "cuda",
         "source": "vgqa_tpu_torch/csrc/gemm_sm90.cu (GEMM), "
                   "vgqa_tpu_torch/csrc/window_attn_sm90.cu (bf16 attention), "
                   "vgqa_tpu_torch/csrc/kernels.cu (LayerNorm, f32 attention)",
         "replaces": "vgqa_tpu/ops/pallas/swin_block.py:388",
         "launches": serve_launches["swin_block_canvas"] + tr["launches"]["swin_block_canvas"]
         + tr420["launches"]["swin_block_canvas"] + tr32["launches"]["swin_block_canvas"]
         + vl["swin_block_canvas"] + dl["swin_block_canvas"],
         "launches_by_path": {"serve": serve_launches["swin_block_canvas"],
                              "train": tr["launches"]["swin_block_canvas"],
                              "train_420": tr420["launches"]["swin_block_canvas"],
                              "train_f32": tr32["launches"]["swin_block_canvas"],
                              "train_vidstg": vl["swin_block_canvas"],
                              "train_ddp": dl["swin_block_canvas"], "qa": 0},
         "max_abs_err": max(r["max_abs_err"] for r in k1_rows + k1_train_rows),
         "ms": k1_fwd, "plain_ms": k1_plain, "bound_ms": k1_bound, "bound_by": k1_by,
         "library_ms": None, "device_ms": k1_device, "gemm_device_ms": k1_phase["gemm"],
         "attn_device_ms": k1_phase["attn"], "ln_device_ms": k1_phase["ln"],
         "chain_floor_ms": k1_floor,
         "train_step_ms": sum(r["ms"] * r["per_fwd"] for r in k1_train_rows),
         "train_step_plain_ms": sum(r["plain_ms"] * r["per_fwd"] for r in k1_train_rows),
         "train_step_bound_ms": sum(r["bound_ms"] * r["per_fwd"] for r in k1_train_rows),
         "f32": f32_k1_row},
        {"name": "swin_block_fused", "route": "cuda",
         "source": "vgqa_tpu_torch/csrc/gemm_sm90.cu, vgqa_tpu_torch/csrc/window_attn_sm90.cu, "
                   "vgqa_tpu_torch/csrc/kernels.cu (K1's chain with identity row maps)",
         "replaces": "vgqa_tpu/ops/pallas/swin_block.py:212",
         "launches": tower["blocks"]["launches"]["swin_block_fused"],
         "launches_by_path": {"serve": 0, "train": 0, "qa": 0,
                              "swin_blocks": tower["blocks"]["launches"]["swin_block_fused"]},
         "max_abs_err": max(r["max_abs_err"] for r in k1f_rows),
         "ms": sum(r["ms"] * r["per_fwd"] for r in k1f_rows),
         "plain_ms": sum(r["plain_ms"] * r["per_fwd"] for r in k1f_rows),
         "bound_ms": sum(r["bound_ms"] * r["per_fwd"] for r in k1f_rows),
         "bound_by": max(k1f_rows, key=lambda r: r["bound_ms"] * r["per_fwd"])["bound_by"],
         "library_ms": None,
         "vs_k1_max_abs": max(r["vs_k1_max_abs"] for r in k1f_rows),
         "f32": {"max_rel_err": max(r["fused_rel_err"] for r in f32_k1),
                 "max_abs_err": max(r["fused_max_abs_err"] for r in f32_k1),
                 "vs_k1_max_abs": max(r["fused_vs_k1_max_abs"] for r in f32_k1),
                 "ms_420_shapes": sum(r["fused_ms"] * r["per_step"] for r in f32_k1)}},
        {"name": "window_attention", "route": "cuda",
         "source": "vgqa_tpu_torch/csrc/window_attn_sm90.cu (bf16: the encoder's key-mask "
                   "form and K1's bias / region form); vgqa_tpu_torch/csrc/kernels.cu "
                   "(float32)",
         "replaces": "vgqa_tpu/ops/pallas/window_attention.py:85",
         "launches": serve_launches["window_attention"] + tr["launches"]["window_attention"]
         + vl["window_attention"] + dl["window_attention"],
         "launches_by_path": {"serve": serve_launches["window_attention"],
                              "train": tr["launches"]["window_attention"],
                              "train_vidstg": vl["window_attention"],
                              "train_ddp": dl["window_attention"], "qa": 0},
         "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
         "ms": 6 * k2["ms"], "plain_ms": 6 * k2["plain_ms"], "bound_ms": 6 * k2["bound_ms"],
         "bound_by": k2["bound_by"], "library_ms": 6 * k2["library_ms"],
         "device_kernel": K2_NAMES[0], "device_ms": 6 * k2["device_ms"],
         "library_device_ms": 6 * k2["library_device_ms"],
         "exp_floor_ms": 6 * k2["exp_floor_ms"],
         "call_device_ms": {r["S"]: r["device_ms"] for r in k2_rows},
         "call_library_device_ms": {r["S"]: r["library_device_ms"] for r in k2_rows},
         "call_bound_ms": {r["S"]: r["bound_ms"] for r in k2_rows},
         "call_exp_floor_ms": {r["S"]: r["exp_floor_ms"] for r in k2_rows},
         "f32": f32_k2},
        {"name": "flash_mha_train", "route": "cuda",
         "source": "vgqa_tpu_torch/csrc/flash_attention.cu (forward), "
                   "vgqa_tpu_torch/csrc/flash_train.cu (backward)",
         "replaces": "vgqa_tpu/ops/pallas/flash_train.py:223",
         "launches": k3_launches["fwd"] + k3_launches["bwd"],
         "launches_by_path": {"serve": 0, "qa": 0,
                              "train": tr["launches"]["flash_mha_train.fwd"]
                              + tr["launches"]["flash_mha_train.bwd"],
                              "train_420": tr420["launches"]["flash_mha_train.fwd"]
                              + tr420["launches"]["flash_mha_train.bwd"],
                              "train_f32": tr32["launches"]["flash_mha_train.fwd"]
                              + tr32["launches"]["flash_mha_train.bwd"],
                              "train_vidstg": vl["flash_mha_train.fwd"]
                              + vl["flash_mha_train.bwd"],
                              "train_ddp": dl["flash_mha_train.fwd"]
                              + dl["flash_mha_train.bwd"]},
         "launches_by_direction": k3_launches,
         "max_abs_err": max(r["max_abs_err"] for r in k3_rows),
         "ms": 6 * (k3["fwd_ms"] + k3["bwd_ms"]), "plain_ms": 6 * k3["plain_ms"],
         "bound_ms": 6 * (k3["fwd_bound_ms"] + k3["bwd_bound_ms"]), "bound_by": k3["bound_by"],
         "library_ms": 6 * k3_lib["library_ms"],
         "fwd_ms": k3["fwd_ms"], "bwd_ms": k3["bwd_ms"],
         "device_ms": 6 * (k3["fwd_device_ms"] + k3["bwd_device_ms"]),
         "fwd_device_ms": k3["fwd_device_ms"], "bwd_device_ms": k3["bwd_device_ms"],
         "library_device_ms": 6 * (k3_lib["library_fwd_device_ms"]
                                   + k3_lib["library_bwd_device_ms"]),
         "library_dropout_ms": 6 * (k3["library_fwd_device_ms"] + k3["library_bwd_device_ms"]),
         "step_420_device_ms": tr420["k3_device_ms"],
         "step_420_bound_ms": 6 * (k3_420["fwd_bound_ms"] + k3_420["bwd_bound_ms"]),
         "f32": {"max_rel_err": max(r["max_rel_err"] for r in f32_rows["k3"]),
                 "max_abs_err": max(r["max_abs_err"] for r in f32_rows["k3"]),
                 "fwd_ms": f32_k3[0.1]["fwd_ms"], "bwd_ms": f32_k3[0.1]["bwd_ms"],
                 "fwd_device_ms": f32_k3[0.1]["fwd_device_ms"],
                 "bwd_device_ms": f32_k3[0.1]["bwd_device_ms"],
                 "rate0_device_ms": f32_k3[0.0]["fwd_device_ms"]
                 + f32_k3[0.0]["bwd_device_ms"],
                 "fwd_bound_ms": f32_k3[0.1]["fwd_bound_ms"],
                 "bwd_bound_ms": f32_k3[0.1]["bwd_bound_ms"],
                 "library_ms": f32_k3[0.0]["library_ms"],
                 "library_device_ms": f32_k3[0.1]["library_fwd_device_ms"]
                 + f32_k3[0.1]["library_bwd_device_ms"],
                 "library_rate0_device_ms": f32_k3[0.0]["library_fwd_device_ms"]
                 + f32_k3[0.0]["library_bwd_device_ms"],
                 "keep_bits_equal_bf16": f32_k3[0.1]["keep_bits_equal_bf16"],
                 "in_step_device_ms": tr32["k3_device_ms"]}},
        dict(qa_row("flash_mha", "vgqa_tpu/ops/pallas/flash_attention.py:79", qa_l,
                    k4_rows[:1], qa["per_chat"]["flash_mha"], k4_rows),
             device_ms=qa["per_chat"]["flash_mha"] * k4["device_ms"],
             library_device_ms=qa["per_chat"]["flash_mha"] * k4["library_device_ms"],
             exp_floor_ms=qa["per_chat"]["flash_mha"] * k4["exp_floor_ms"],
             call_device_ms=k4["device_ms"], call_library_device_ms=k4["library_device_ms"],
             masked_call_device_ms=k4_rows[1]["device_ms"]),
        dict(qa_row("flash_gqa_causal", "vgqa_tpu/ops/pallas/flash_attention.py:242", qa_l,
                    k5_rows, 32, k5_rows),
             device_kernel=K5_NAMES[0],
             device_ms=32 * sum(r["device_ms"] for r in k5_rows),
             library_device_ms=32 * sum(r["library_device_ms"] for r in k5_rows),
             exp_floor_ms=32 * sum(r["exp_floor_ms"] for r in k5_rows),
             chunk_device_ms=[r["device_ms"] for r in k5_rows],
             chunk_library_device_ms=[r["library_device_ms"] for r in k5_rows]),
        dict(qa_row("int4_matmul", "vgqa_tpu/ops/pallas/int4_matmul.py:145", qa_l,
                    [next(r for r in k6_rows if (r["K"], r["N"], r["M"]) == (k, n, 1))
                     for k, n, _ in QA_PROJ], 32, k6_rows),
             device_ms_per_token=k6_token_ms, host_us_per_call=k6_host_us),
    ]}
    for row in table["kernels"]:           # the HTTP phase's launches, path by path
        n = (http_l[row["name"]] if row["name"] in http_l
             else http_l["flash_mha_train.fwd"] + http_l["flash_mha_train.bwd"])
        row["launches"] += n
        row["launches_by_path"]["serve_http"] = n
    hr, ro = http["runs"], http["rounds"]
    print(f"serve_http (420 px grounding, bf16; QA 7.7B bf16, 8,192-token context): wall "
          f"s/request {json.dumps({k: round(v, 4) for k, v in http['walls'].items()})}; "
          f"/api/predict x4 concurrent, median of {HTTP_POLICY_ROUNDS} bursts: pipelined "
          f"{ro['pipelined']['median_wall_s']:.4f} s/burst ({ro['pipelined']['clips_per_s']:.2f}"
          f" clips/s, request latency median {ro['pipelined']['median_latency_s']:.4f} s), "
          f"coalesced {ro['coalesced']['median_wall_s']:.4f} s/burst "
          f"({ro['coalesced']['clips_per_s']:.2f} clips/s, request latency median "
          f"{ro['coalesced']['median_latency_s']:.4f} s); idle share of a profiled burst "
          f"pipelined {(ro['pipelined']['profiled'] or {}).get('idle_share', 'not measured')}, "
          f"coalesced {(ro['coalesced']['profiled'] or {}).get('idle_share', 'not measured')}; "
          f"peak of the V = 4 forward {hr['coalesced']['peak_gb']:.2f} GiB (V = 2: "
          f"{hr['pipelined']['peak_gb']:.2f}); coalesced vs pipelined max |d box| "
          f"{http['box_diff']:.3f} px, max |d score| {http['att_diff']:.4f}; launches {http_l}"
          f"  [{card}]")
    print("kernel table: ms / plain_ms / bound_ms / library_ms = sum over one V=2 forward "
          "at 224 px for K1 and K1' (their 12 calls) and K2 (6 calls at S=124; "
          "device_ms / library_device_ms / exp_floor_ms the same by device time, call_* "
          "per call at S=124 and 418), over one "
          "train step "
          "at 64f@224 for K3 (6 forward + 6 backward calls at [512, 124, 32], rate 0.1; "
          "library: SDPA fwd+bwd at rate 0; *_device_ms the same by device time (profiler), "
          "library_dropout_ms SDPA's at dropout_p 0.1; step_420_device_ms K3's device time "
          "in one profiled 64f@420 step, step_420_bound_ms its bound); launches over "
          "the serving (4 forwards) and training (3 steps at 224 px, 3 at 420 px, 2 f32 "
          "steps of configs/grounding_vidstg.yaml at 64f@420) runs, and train_vidstg (8 f32 "
          "steps over the data path, its test and the evaluate tool: 16 half-passes); each "
          "\"f32\" entry: the "
          "float32 form at the f32 step's shapes (K1: the 12 calls of a 64f@420 step, "
          "in_step_device_ms from the profiled f32 step; K2 one call at S=418; K3 per call "
          "at [512, 418, 32], rate 0.1, bounds at the FFMA rate, K1's step_bound_ms with "
          "its GEMM as 3xTF32 and step_ffma_bound_ms all on FFMA; library: SDPA on the "
          "same f32 operands, K3's library_ms fwd+bwd at rate 0 by events, "
          "library_device_ms at rate 0.1 by device time); f32 step "
          f"{tr32['ms_step']:.1f} ms, peak {tr32['peak_gb']:.2f} GiB; K4 device_ms / "
          "library_device_ms / exp_floor_ms per chat by the profiler; train "
          f"step {tr['ms_step']:.1f} ms, peak {tr['peak_gb']:.2f} GiB; train_vidstg (the data "
          f"path, f32 64f@420): {vidstg['s_step']:.3f} s/step over steps 3-8 "
          f"({vidstg['s_step_unprofiled']:.3f} over 3-6 unprofiled), loader wait "
          f"{vidstg['loader_wait_s']:.3f} s/step, idle share {vidstg['idle_share']:.3f}, eval "
          f"{vidstg['eval_s_item']:.3f} s/test item, peak {vidstg['peak_gb']:.2f} GiB, "
          f"launches over 8 steps + test + the evaluate tool; train_ddp (the same path, "
          f"data-parallel): launches summed over its ranks, 2 gloo ranks on card 0 (4 steps "
          f"+ test each) and NCCL at world size {ddp['nccl_world']}; at 64f@420 "
          f"{tr420['ms_step']:.1f} ms, peak {tr420['peak_gb']:.2f} GiB, K3 device "
          f"{tr420['k3_device_ms']:.3f} ms per step; K1' launches over the tower's blocks "
          "route; Swin-T "
          f"tower ms canvas / blocks / module {tower['canvas']['ms']:.2f} / "
          f"{tower['blocks']['ms']:.2f} / {tower['module']['ms']:.2f}; trainable-tower train "
          f"step {tr_swin['step_ms'][-1]:.1f} ms, peak {tr_swin['peak_gb']:.2f} GiB; "
          f"K4 over one 32-frame chat (96 calls at "
          "[128, 1025, 64], unmasked), K5 over one 32-frame prefill (32 layers x the 9 "
          "chunk offsets; device_ms / library_device_ms by device time, chunk_* per chunk), K6 over one int4 decode token at M = 1 (32 layers x 7 "
          "projections; library: see the K6 lines); QA launches over the bf16, int4, "
          f"sampled and batched chats; QA last-prompt-token logits kernel vs plain routes "
          f"rel err bf16 {qa['rel_bf16']:.3e}, int4 {qa['rel_int4']:.3e} (K4, K5); int4 "
          f"decode-step logits {qa['rel_int4_decode']:.3e} (K6); K6 host {k6_host_us:.2f} us "
          f"per call; bf16 GEMMs rounded once: at most "
          f"{100 * max(r['frac_differ'] for r in quant_rows):.4f}% of elements differ  [{card}]")
    print(f"profiler windows taken again: {len(RETAKEN)}")
    for line in RETAKEN:
        print("  " + line)
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
