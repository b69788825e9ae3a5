"""Chip smoke test of the PyTorch/CUDA port (vgqa_tpu_torch) on one GPU.

    python3 chip_smoke.py

1. Prints the card (nvidia-smi name and power limit) and the torch/CUDA
   versions; fails at once when no CUDA device is visible.
2. Builds the hand-written kernels from vgqa_tpu_torch/csrc and prints the
   build seconds.
3. Checks each kernel against its plain PyTorch version (float32 on the same
   bf16 inputs) at the shapes the serving path gives it, with the error
   relative to max |ref| (fails above 3e-2) and both times (CUDA events).
4. Serves the full-width default grounding model (ResNet-101, Video Swin-T,
   RoBERTa-base, 6-layer encoder, 6+6 decoders) with random weights from
   seed 0 in bf16: one warm-up request, then three pipelined 128-frame
   requests at 224 px and one at 420 px through predict_many's
   decoded-frames path, checking each response and that the K1/K2 launch
   counters rose by 12/6 per forward; then one forward with the kernel
   routes on against the same model with the plain routes.
5. Prints a JSON line with the kernel table, then, as the last line,
   {"ok": true, "device": {...}}.

Any failure raises (non-zero exit) before the last line is printed.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

REL_TOL = 3e-2      # bf16 kernel vs f32 plain version, relative to max |ref|
WARMUP, REPS = 2, 5


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


def check_window_attention(dev, g):
    from vgqa_tpu_torch.ops.kernels.window_attention import (
        window_attention, window_attention_reference)

    rows = []
    for S in (124, 418):                  # 224 px and 420 px encoder rows
        q, k, v = (torch.randn(128, S, 256, generator=g, device=dev).bfloat16()
                   for _ in range(3))
        kv = (torch.rand(128, S, generator=g, device=dev) > 0.1).float()
        kv[:, 0] = 1.0
        f32 = [t.float() for t in (q, k, v)]
        out = window_attention(q, k, v, key_valid=kv, num_heads=8)
        ref = window_attention_reference(*f32, key_valid=kv, num_heads=8)
        torch.cuda.synchronize()
        rel, mae = rel_err(out, ref)
        ms = cuda_ms(lambda: window_attention(q, k, v, key_valid=kv, num_heads=8))
        plain = cuda_ms(lambda: window_attention_reference(*f32, key_valid=kv, num_heads=8))
        rows.append({"S": S, "rel_err": rel, "max_abs_err": mae, "ms": ms, "plain_ms": plain})
        print(f"K2 window_attention W=128 S={S} C=256 h=8: rel_err {rel:.3e} "
              f"max_abs_err {mae:.3e}  kernel {ms:.3f} ms  plain(f32) {plain:.3f} ms")
        if not rel < REL_TOL:
            raise AssertionError(f"window_attention S={S}: rel_err {rel} >= {REL_TOL}")
    return rows


def check_swin_block(dev, g):
    from vgqa_tpu_torch.models.video_swin import (
        _adjust_window, _region_partition, _valid_partition)
    from vgqa_tpu_torch.ops.kernels.swin_block import (
        swin_block_canvas, swin_block_canvas_reference)

    # (dims D, H, W, C, heads, shift, calls of this shape per forward at 224 px)
    cases = [
        ((64, 56, 56), 96, 3, (0, 0, 0), 1), ((64, 56, 56), 96, 3, (4, 3, 3), 1),
        ((64, 28, 28), 192, 6, (0, 0, 0), 1), ((64, 28, 28), 192, 6, (4, 3, 3), 1),
        ((64, 14, 14), 384, 12, (0, 0, 0), 3), ((64, 14, 14), 384, 12, (4, 3, 3), 3),
        ((64, 7, 7), 768, 24, (0, 0, 0), 1), ((64, 7, 7), 768, 24, (4, 3, 3), 1),
        ((64, 53, 53), 192, 6, (4, 3, 3), 0),    # 420 px stage 1: padded to 56, valid
    ]
    rows = []
    for dims, C, heads, shift, per_fwd in cases:
        window, shift = _adjust_window(dims, (8, 7, 7), shift)
        padded = tuple(d + (-d) % w for d, w in zip(dims, window))
        N = window[0] * window[1] * window[2]

        def rnd(*s, sc=1.0):
            return (sc * torch.randn(*s, generator=g, device=dev)).bfloat16()

        ws = [1 + rnd(C, sc=0.1), rnd(C, sc=0.1), rnd(C, 3 * C, sc=C ** -0.5),
              rnd(3 * C, sc=0.1), rnd(C, C, sc=C ** -0.5), rnd(C, sc=0.1),
              1 + rnd(C, sc=0.1), rnd(C, sc=0.1), rnd(C, 4 * C, sc=C ** -0.5),
              rnd(4 * C, sc=0.1), rnd(4 * C, C, sc=(4 * C) ** -0.5), rnd(C, sc=0.1)]
        canvas = rnd(2, *padded, C)
        bias = rnd(heads, N, N, sc=0.5)
        region = (torch.from_numpy(_region_partition(padded, window, shift)).to(dev)
                  if any(shift) else None)
        valid = _valid_partition(dims, padded, window, shift)
        valid = None if valid is None else torch.from_numpy(valid).to(dev)
        args = (canvas, *ws, bias, heads, window, shift)
        f32 = (canvas.float(), *[w.float() for w in ws], bias.float(), heads, window, shift)
        out = swin_block_canvas(*args, region=region, valid=valid)
        ref = swin_block_canvas_reference(*f32, region=region, valid=valid)
        torch.cuda.synchronize()
        rel, mae = rel_err(out, ref)
        del out, ref
        ms = cuda_ms(lambda: swin_block_canvas(*args, region=region, valid=valid))
        plain = cuda_ms(lambda: swin_block_canvas_reference(*f32, region=region, valid=valid))
        rows.append({"dims": dims, "C": C, "shift": shift, "per_fwd": per_fwd,
                     "rel_err": rel, "max_abs_err": mae, "ms": ms, "plain_ms": plain})
        print(f"K1 swin_block_canvas B=2 {dims}->{padded} C={C} h={heads} roll={shift} "
              f"valid={valid is not None}: rel_err {rel:.3e} max_abs_err {mae:.3e}  "
              f"kernel {ms:.3f} ms  plain(f32) {plain:.3f} ms")
        if not rel < REL_TOL:
            raise AssertionError(f"swin_block_canvas {dims} C={C}: rel_err {rel} >= {REL_TOL}")
    return rows


def full_cfg(res: int):
    from vgqa_tpu_torch.config import build_default_cfg

    cfg = build_default_cfg()
    cfg.INPUT.RESOLUTION = res
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 1
    card = card_line()
    print(card)
    print(f"python {sys.version.split()[0]}  torch {torch.__version__}  cuda {torch.version.cuda}"
          f"  device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 plain versions stay f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    from vgqa_tpu_torch.inference.grounding import load_model, predict_many
    from vgqa_tpu_torch.ops.kernels import build
    from vgqa_tpu_torch.ops.kernels.swin_block import swin_block_canvas
    from vgqa_tpu_torch.ops.kernels.window_attention import window_attention

    t0 = time.perf_counter()
    build.load_library()
    print(f"kernels built+loaded in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_log['seconds']:.2f} s) -> {build.build_log['path']}")
    for line in build.build_log["ptxas"].splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())

    g = torch.Generator(device=dev).manual_seed(0)
    k2_rows = check_window_attention(dev, g)
    k1_rows = check_swin_block(dev, g)
    torch.cuda.empty_cache()

    # ---- serving: full-width default config, random weights, bf16 ----------
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

    swin_block_canvas.launches = 0
    window_attention.launches = 0
    reqs = make_requests(3, 224, seed=2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = predict_many(reqs, loaded=loaded)
    t224 = time.perf_counter() - t0
    reqs420 = make_requests(1, 420, seed=3)
    t0 = time.perf_counter()
    outs += predict_many(reqs420, loaded=loaded_420)
    t420 = time.perf_counter() - t0
    launches = {"swin_block_canvas": swin_block_canvas.launches,
                "window_attention": window_attention.launches}
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
    if launches != {"swin_block_canvas": 12 * forwards, "window_attention": 6 * forwards}:
        raise AssertionError(f"expected 12 and 6 launches per forward, got {launches}")
    print("response 0:", json.dumps({"temporal": outs[0]["temporal"],
                                     "tube[0]": outs[0]["tube"][0]}))

    # ---- kernel routes vs plain routes on one full-width forward ----------
    from vgqa_tpu_torch.inference.grounding import _group_inputs, _prepare
    from vgqa_tpu_torch.training.evaluator import dispatch_forward

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

    k1_fwd = sum(r["ms"] * r["per_fwd"] for r in k1_rows)
    k1_plain = sum(r["plain_ms"] * r["per_fwd"] for r in k1_rows)
    table = {"kernels": [
        {"name": "swin_block_canvas", "route": "cuda",
         "source": "vgqa_tpu_torch/csrc/kernels.cu",
         "replaces": "vgqa_tpu/ops/pallas/swin_block.py:388",
         "launches": launches["swin_block_canvas"],
         "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
         "ms": k1_fwd, "plain_ms": k1_plain},
        {"name": "window_attention", "route": "cuda",
         "source": "vgqa_tpu_torch/csrc/kernels.cu",
         "replaces": "vgqa_tpu/ops/pallas/window_attention.py:85",
         "launches": launches["window_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
         "ms": 6 * k2_rows[0]["ms"], "plain_ms": 6 * k2_rows[0]["plain_ms"]},
    ]}
    print("kernel table: ms / plain_ms = sum over one V=2 forward at 224 px "
          "(K1: its 12 calls; K2: 6 calls at S=124)")
    print(json.dumps(table))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
