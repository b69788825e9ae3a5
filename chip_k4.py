"""The Hopper attention kernels on one GPU: this tree against another
checkout (for example the parent commit unpacked by ``git archive``), in
turns.

    python3 chip_k4.py [--kernel k4|k2|k5|k1|k1f32|trainf32] [--other DIR] [--sass]

Each timing run is its own process, in the order other, this, this, other,
so that both trees see the card alike. A run imports ``vgqa_tpu_torch`` and
``chip_smoke`` from its tree and times one kernel at the shapes of its main
path: the error against the plain version, CUDA-event ms per call over 50
back-to-back calls and device ms per call under the profiler (20 calls),
and SDPA (``scaled_dot_product_attention``, the yardstick; the port never
calls it) the same way in the same process. Device time is read by this
tree's ``chip_smoke.device_kernels`` in every run, beside the wrapper's own
launch counter.

* ``k4`` (default): K4 ``flash_mha`` at one InternViT call ([8 tiles, 1025,
  16 x 64] as slices of one fused qkv tensor), maskless and masked.
* ``k2``: K2 ``window_attention`` at the encoder's calls (W 128, 8 heads of
  32, key_valid) at S = 124 and 418; SDPA with a bool key mask.
* ``k5``: K5 ``flash_gqa_causal`` at the 9 chunks of a 32-frame prefill (H
  32, Hkv 8, dh 128, Lq 1024, S 9216, length 8700; q the [L, H, dh] ->
  [H, L, dh] view), and their sum x 32 layers per prefill; SDPA with
  ``enable_gqa`` and the bool (causal, length) mask.
* ``k1``: K1 ``swin_block_canvas`` in bf16 at the 12 block calls of a V = 2
  serving forward at 224 px (chip_smoke's K1_SERVE_CASES), device ms per
  phase (GEMM, attention, LayerNorm; each tree's kernel names) and CUDA
  events, summed per forward; no yardstick (no PyTorch call computes a Swin
  block).
* ``k1f32``: the same in float32 at the 12 block calls of a 64f@420 train
  step (K1_420_CASES, B = 1, DropPath gates), summed per step.
* ``trainf32``: the whole float32 train step end to end, as this tree's
  ``chip_smoke.train_steps`` takes it on each tree's package (that tree's
  ``configs/grounding_vidstg.yaml``, 64f@420, V = 1, random weights from
  seed 0, its checks and 2 steps), then
  STEPS steps one at a time: CUDA-event ms and the host's ms to enqueue the
  step (``chip_smoke.timed``; the host paces the step where the two agree),
  and two profiled steps: wall, device busy, idle share, kernel launches,
  K1's device ms, and where the device idles: before K1's first kernel,
  inside K1's span and after its last kernel, and how far the device runs
  past the host's last CUDA call. Timed twice in each run, the flags set
  for each: ``f32``, TF32 off in cuBLAS and cuDNN (every float32 product in
  f32: the port's entry points' policy), then ``cudnn_tf32``, PyTorch's
  default in cuDNN (TF32 convolutions; matmuls stay f32).

``--sass`` (with ``--other``) compiles both trees' ``csrc/flash_attention.cu``
and ``csrc/flash_mha_sm90.cu`` and compares K3's forward
(``attn_fwd_kernel<32, 2>``) and K4 (``flash_mha_sm90_kernel``) line for
line after normalising constant-bank offsets, and counts HGMMA, UTMALDG and
MUFU.EX2 in this tree's Hopper kernels (K4, K2's and K5's). The card line
(``nvidia-smi --query-gpu=name,power.limit``) is printed first. Any failure
exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
T, L, H, D = 8, 1025, 16, 64                   # K4: one InternViT call
K2_W, K2_C, K2_H = 128, 256, 8                 # K2: the encoder's rows
K5_H, K5_HKV, K5_LQ, K5_S, K5_D, K5_LEN = 32, 8, 1024, 9216, 128, 8700

# each kernel's device kernels in this tree, and in trees from before its
# Hopper redesign
NAMES = {"k4": ("flash_mha_sm90_kernel", "attn_fwd_kernel<64"),
         "k2": ("window_attn_sm90_kernel", "window_attn_kernel"),
         "k5": ("flash_gqa_sm90_kernel", "attn_fwd_kernel<128")}
# K1's phases, by the kernel names of this tree and of trees from before its
# Hopper redesign (WMMA GEMM, mma.sync attention, FFMA float32 GEMM)
K1_PHASES = {False: {"gemm": ("gemm_sm90_kernel", "gemm_bf16_kernel"),
                     "attn": ("window_attn_sm90_kernel", "window_attn_kernel"),
                     "ln": ("ln_rows_kernel",)},
             True: {"gemm": ("gemm_sm90_kernel", "gemm_f32_kernel"),
                    "attn": ("window_attn_f32_kernel",),
                    "ln": ("ln_rows_kernel",)}}


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _timed(cs, kernel, fn, library, counter, rel):
    """One row: error, kernel and SDPA by CUDA events and by device time."""
    n, _, dev_ms, all_ms = cs.device_kernels(fn, calls=20, names=NAMES[kernel],
                                             counter=counter)
    return {"rel_err": rel, "events_ms": cs.cuda_ms(fn, reps=50), "device_ms": dev_ms,
            "kernels_per_call": n, "all_kernels_device_ms": all_ms,
            "sdpa_events_ms": cs.cuda_ms(library, reps=50),
            "sdpa_device_ms": cs.device_kernels(library, calls=20)[3]}


def child_k4(cs) -> dict:
    import torch

    from vgqa_tpu_torch.ops.kernels.flash_attention import flash_mha, flash_mha_reference

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(T, L, 3 * H * D, generator=g, device=dev).bfloat16()
    q, k, v = qkv.split(H * D, dim=-1)
    mask = torch.rand(T, L, generator=g, device=dev) > 0.2
    mask[:, 0] = True
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def heads(t):
        return t.reshape(T, L, H, D).transpose(1, 2)

    out = {}
    for masked in (False, True):
        m = mask if masked else None
        am = None if m is None else m[:, None, None, :]
        rel = cs.rel_err(flash_mha(q, k, v, H, key_mask=m),
                         flash_mha_reference(q.float(), k.float(), v.float(), H, key_mask=m))[0]
        if not rel < cs.REL_TOL:
            raise AssertionError(f"flash_mha masked={masked}: rel_err {rel}")
        out["K4 [128, 1025, 64] " + ("masked" if masked else "maskless")] = _timed(
            cs, "k4", lambda: flash_mha(q, k, v, H, key_mask=m),
            lambda: sdpa(heads(q), heads(k), heads(v), attn_mask=am),
            lambda: flash_mha.launches, rel)
    return out


def child_k2(cs) -> dict:
    import torch

    from vgqa_tpu_torch.ops.kernels.window_attention import (
        window_attention, window_attention_reference)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for S in (124, 418):
        q, k, v = (torch.randn(K2_W, S, K2_C, generator=g, device=dev).bfloat16()
                   for _ in range(3))
        kv = (torch.rand(K2_W, S, generator=g, device=dev) > 0.1).float()
        kv[:, 0] = 1.0
        rel = cs.rel_err(window_attention(q, k, v, key_valid=kv, num_heads=K2_H),
                         window_attention_reference(q.float(), k.float(), v.float(),
                                                    key_valid=kv, num_heads=K2_H))[0]
        if not rel < cs.REL_TOL:
            raise AssertionError(f"window_attention S={S}: rel_err {rel}")

        def heads(t):
            return t.reshape(K2_W, S, K2_H, K2_C // K2_H).transpose(1, 2)

        am = (kv > 0)[:, None, None, :]
        out[f"K2 W=128 S={S} C=256 h=8 key_valid"] = _timed(
            cs, "k2", lambda: window_attention(q, k, v, key_valid=kv, num_heads=K2_H),
            lambda: sdpa(heads(q), heads(k), heads(v), attn_mask=am),
            lambda: window_attention.launches, rel)
    return out


def child_k5(cs) -> dict:
    import torch

    from vgqa_tpu_torch.ops.kernels.flash_attention import (
        flash_gqa_causal, flash_gqa_causal_reference)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn(K5_LQ, K5_H, K5_D, generator=g, device=dev).bfloat16().transpose(0, 1)
    k, v = (torch.randn(K5_HKV, K5_S, K5_D, generator=g, device=dev).bfloat16()
            for _ in range(2))
    n = torch.tensor(K5_LEN, device=dev)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kpos = torch.arange(K5_S, device=dev)
    out = {}
    for off in range(0, K5_S, K5_LQ):
        rel = None
        if off in (0, 8192):
            rel = cs.rel_err(flash_gqa_causal(q, k, v, off, n),
                             flash_gqa_causal_reference(q.float(), k.float(), v.float(),
                                                        off, n))[0]
            if not rel < cs.REL_TOL:
                raise AssertionError(f"flash_gqa_causal q_offset={off}: rel_err {rel}")
        qpos = off + torch.arange(K5_LQ, device=dev)
        am = (kpos[None, :] <= qpos[:, None]) & (kpos[None, :] < K5_LEN)
        out[f"K5 q_offset {off}"] = _timed(
            cs, "k5", lambda: flash_gqa_causal(q, k, v, off, n),
            lambda: sdpa(q[None], k[None], v[None], attn_mask=am, enable_gqa=True),
            lambda: flash_gqa_causal.launches, rel)
    return out


def child_k1(cs, f32: bool) -> dict:
    """K1 at the block calls of a serving forward (bf16) or of a 64f@420
    step (float32): per call error, events ms, device ms per phase."""
    import torch

    from vgqa_tpu_torch.ops.kernels.swin_block import (
        swin_block_canvas, swin_block_canvas_reference)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    dtype = torch.float32 if f32 else torch.bfloat16
    cases = cs.K1_420_CASES if f32 else [c for c in cs.K1_SERVE_CASES if c[-1]]
    batch = 1 if f32 else 2
    out = {}
    for i, (dims, C, heads, shift, per) in enumerate(cases):
        window, shift, padded, N, ws, canvas, bias, region, valid = cs._swin_case(
            dev, g, dims, C, heads, shift, batch, dtype=dtype)
        gates = (torch.tensor([[0.0, 1.25]] if i % 2 else [[1.1111, 0.0]], device=dev)
                 if f32 else None)
        args = (canvas, *ws, bias, heads, window, shift)
        kw = {"region": region, "valid": valid, "gates": gates}
        with cs.all_f32():         # the f32 plain version stays f32
            ref = swin_block_canvas_reference(canvas.float(), *[w.float() for w in ws],
                                              bias.float(), heads, window, shift, **kw)
        rel = cs.rel_err(swin_block_canvas(*args, **kw), ref)[0]
        del ref
        if not rel < (cs.F32_TOL if f32 else cs.REL_TOL):
            raise AssertionError(f"swin_block_canvas {dims} C={C}: rel_err {rel}")
        ph = cs.device_phases(lambda: swin_block_canvas(*args, **kw), K1_PHASES[f32],
                              calls=5, counter=lambda: swin_block_canvas.launches)
        out[f"K1 {'f32 ' if f32 else ''}B={batch} {dims} C={C} roll={shift} x{per}"] = {
            "rel_err": rel, "per": per, "events_ms": cs.cuda_ms(
                lambda: swin_block_canvas(*args, **kw), reps=10),
            **{f"{p}_device_ms": v for p, v in ph.items()}}
        del canvas, ws, bias
        torch.cuda.empty_cache()
    from vgqa_tpu_torch.ops.kernels import swin_block as sb

    if hasattr(sb, "gemm_plan"):      # this tree's GEMM alone, per layer and stage
        out["gemm_layers"] = gemm_layers(cs, sb, cases, batch, dtype)
    return out


STEPS = 6          # trainf32: steps timed one at a time after the checked ones
K1_F32_KERNELS = tuple(n for names in K1_PHASES[True].values() for n in names)


def step_timeline(step) -> dict:
    """One ``step()`` under torch.profiler: wall ms, the device's busy ms
    (the union of kernel intervals), its kernels, K1's device ms, and the
    device's idle ms before K1's first kernel, inside K1's span and after
    its last kernel, and ``device_past_host_ms``, how long the last kernel
    ends after the host's last CUDA call (the device's backlog at the end)."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(3):      # a window the profiler left without K1's kernels is retaken
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        dev, host_end = [], 0.0
        for e in prof.events():
            if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
                dev.append((e.time_range.start, e.time_range.end, e.name))
            elif e.name.startswith("cu") and "Synchronize" not in e.name:
                host_end = max(host_end, e.time_range.end)
        dev.sort()
        k1 = [(a, b) for a, b, n in dev if any(k in n for k in K1_F32_KERNELS)]
        if k1:
            break
    else:
        raise RuntimeError(f"three profiled steps held no K1 kernel ({len(dev)} kernels)")
    first, last = dev[0][0], max(b for _, b, _ in dev)
    k1_lo, k1_hi = k1[0][0], max(b for _, b in k1)

    def busy(lo, hi):           # us of [lo, hi] covered by some kernel
        total, end = 0.0, lo
        for a, b, _ in dev:
            a, b = max(a, end), min(b, hi)
            if b > a:
                total += b - a
                end = b
        return total

    return {"wall_ms": wall, "busy_ms": busy(first, last) / 1e3,
            "idle": 1 - busy(first, last) / 1e3 / wall, "kernels": len(dev),
            "k1_device_ms": sum(b - a for a, b in k1) / 1e3,
            "idle_before_k1_ms": (k1_lo - first - busy(first, k1_lo)) / 1e3,
            "idle_in_k1_ms": (k1_hi - k1_lo - busy(k1_lo, k1_hi)) / 1e3,
            "idle_after_k1_ms": (last - k1_hi - busy(k1_hi, last)) / 1e3,
            "after_k1_ms": (last - k1_hi) / 1e3,
            "device_past_host_ms": (last - host_end) / 1e3}


def child_train_f32(cs, tree: str) -> dict:
    """The float32 64f@420 train step of ``tree`` (see ``trainf32`` above)."""
    import statistics

    import torch

    from vgqa_tpu_torch.config import build_default_cfg

    dev = torch.device("cuda")
    cfg = build_default_cfg()
    cfg.merge_from_file(os.path.join(tree, "configs", "grounding_vidstg.yaml"))
    cfg.OUTPUT_DIR = ""
    cfg.freeze()
    run = cs.train_steps(dev, cs.card_line(), 420, cfg=cfg, steps=2)
    state, step_fn, args = run["trainer"].state, run["trainer"].step_fn, run["args"]

    def step():
        step_fn(state, *args, seed=0)

    out = {"checked_ms_step": run["ms_step"], "peak_gb": run["peak_gb"]}
    for setting in ("f32", "cudnn_tf32"):
        # the two labelled settings, set here for either tree (a tree's own
        # Trainer may set its policy, or none)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = setting == "cudnn_tf32"
        cs.timed(step, reps=1)                  # a warm-up step at this setting
        timed = [cs.timed(step, reps=1) for _ in range(STEPS)]
        prof = [step_timeline(step) for _ in range(2)]
        events = [t[0] for t in timed]
        out[setting] = {"events_ms": events, "host_ms": [t[1] for t in timed],
                        "events_median_ms": statistics.median(events), "profiled": prof}
    return out


def gemm_layers(cs, sb, cases, batch, dtype) -> list:
    """csrc/gemm_sm90.cu alone at each distinct (stage, layer) of the cases:
    its plan, device ms per call, and the bytes / operations bound of the
    layer (A read, W read, output written; residual modes also read it)."""
    import torch

    from vgqa_tpu_torch.ops.kernels import build

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    lib, st = build.load_library(), build.stream_handle(dev)
    f32 = dtype == torch.float32
    elem = 4 if f32 else 2
    peak = (cs.PEAK_TF32 / 3) if f32 else cs.PEAK_BF16
    rows, seen = [], set()
    for dims, C, heads, shift, per in cases:
        M = batch * dims[0] * (-(-dims[1] // 7) * 7) * (-(-dims[2] // 7) * 7)
        if (M, C) in seen:
            continue
        seen.add((M, C))
        for layer, (N, K, mode) in {"qkv": (3 * C, C, 0), "proj": (C, C, 2),
                                   "fc1": (4 * C, C, 1), "fc2": (C, 4 * C, 3)}.items():
            a = torch.randn(M, K, generator=g, device=dev).to(dtype)
            w = (torch.randn(K, N, generator=g, device=dev) * K ** -0.5).to(dtype)
            bias = torch.zeros(N, device=dev, dtype=dtype)
            o = torch.empty(M, N, device=dev, dtype=dtype)
            res = torch.randn(M, N, generator=g, device=dev).to(dtype) if mode >= 2 else None
            ops = sb._weight_operands(w, dev, dtype)

            def run():
                sb._gemm(lib, st, a, ops, bias, o, N, mode, res=res, ldr=N if res is not None
                         else 0)

            ms = cs.device_kernels(run, calls=10, names=("gemm_sm90_kernel",))[2]
            nbytes = (M * K + K * N + M * N * (2 if mode >= 2 else 1)) * elem
            b_ms = 1e3 * max(2.0 * M * N * K / peak, nbytes / cs.PEAK_BYTES)
            plan = sb.gemm_plan(M, N, K, f32)
            rows.append({"C": C, "M": M, "layer": layer, "device_ms": ms, "bound_ms": b_ms,
                         "plan": {k: plan[k] for k in ("bn", "stages", "kps", "resident",
                                                       "grid")}})
            del a, w, o, res, ops
    return rows


def child(tree: str, kernel: str) -> dict:
    sys.path.insert(0, tree)
    cs = _smoke()
    if kernel == "trainf32":
        out = child_train_f32(cs, tree)
        out["profiler_windows_retaken"] = cs.RETAKEN
        return out
    if kernel in ("k1", "k1f32"):
        out = child_k1(cs, kernel == "k1f32")
        out["profiler_windows_retaken"] = cs.RETAKEN
        return out
    out = {"k4": child_k4, "k2": child_k2, "k5": child_k5}[kernel](cs)
    out["profiler_windows_retaken"] = cs.RETAKEN
    return out


def _nvcc() -> str:
    sys.path.insert(0, HERE)
    from vgqa_tpu_torch.ops.kernels import build

    return build._nvcc()


def _sass(src: str, include: str) -> dict:
    """{kernel name with the anonymous namespace normalised: [instructions]}"""
    nvcc = _nvcc()
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    with tempfile.TemporaryDirectory() as tmp:
        cubin = os.path.join(tmp, "k.cubin")
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                        "-I", include, "-cubin", "-o", cubin, src], check=True)
        dump = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True, text=True,
                              check=True).stdout
    funcs, cur = {}, None
    for line in dump.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "ANON", m.group(1))
            funcs[cur] = []
            continue
        if cur and re.search(r"/\*[0-9a-f]{4}\*/", line):
            ins = re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split(";")[0].strip()
            funcs[cur].append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][X]", ins))
    return funcs


def sass_report(other: str) -> bool:
    """K3's forward and K4 against the other tree; opcode counts of the
    Hopper kernels of this one."""
    csrc = os.path.join("vgqa_tpu_torch", "csrc")
    same = True
    for src, inst in (("flash_attention.cu", "attn_fwd_kernelILi32ELi2E"),
                      ("flash_mha_sm90.cu", "flash_mha_sm90_kernel")):
        theirs = _sass(os.path.join(other, csrc, src), os.path.join(other, csrc))
        ours = _sass(os.path.join(HERE, csrc, src), os.path.join(HERE, csrc))
        names = sorted(n for n in ours if inst in n)
        if not names or names != sorted(n for n in theirs if inst in n):
            print(f"SASS {inst}: kernels {names} here, "
                  f"{sorted(n for n in theirs if inst in n)} in the other tree", flush=True)
            same = False
        for name in names:
            ok = name in theirs and ours[name] == theirs[name]
            same &= ok
            print(f"SASS {name}: {len(theirs.get(name, []))} vs {len(ours[name])} "
                  f"instructions, identical after normalising constant-bank offsets: {ok}",
                  flush=True)
    for src in ("flash_mha_sm90.cu", "window_attn_sm90.cu", "flash_gqa_sm90.cu"):
        for name, ins in _sass(os.path.join(HERE, csrc, src), os.path.join(HERE, csrc)).items():
            ops = [i.split()[1] if i.startswith("@") else i.split()[0] for i in ins if i]
            print(f"SASS {name}: {len(ins)} instructions; HGMMA "
                  f"{sum(o.startswith('HGMMA') for o in ops)}, UTMALDG "
                  f"{sum(o.startswith('UTMALDG') for o in ops)}, MUFU.EX2 "
                  f"{sum(o.startswith('MUFU.EX2') for o in ops)}", flush=True)
    return same


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernel", choices=("k4", "k2", "k5", "k1", "k1f32", "trainf32"),
                    default="k4")
    ap.add_argument("--other", help="another checkout to measure in turns with this one")
    ap.add_argument("--sass", action="store_true",
                    help="compare K3-forward and K4 SASS with --other")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print("RESULT " + json.dumps(child(a.child, a.kernel)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    if a.sass and a.other and not sass_report(os.path.abspath(a.other)):
        print("K3's forward or K4 compiled to other code", flush=True)
        return 1
    order = [(HERE, "this"), (HERE, "this")]
    if a.other:
        other = os.path.abspath(a.other)
        order = [(other, "other")] + order + [(other, "other")]
    for tree, label in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--kernel", a.kernel,
                               "--child", tree], capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            sys.stdout.write(proc.stdout + proc.stderr[-6000:])
            print(f"run {label} ({tree}) failed with {proc.returncode}", flush=True)
            return 1
        res = json.loads([ln for ln in proc.stdout.splitlines()
                          if ln.startswith("RESULT ")][-1][7:])
        for line in res.pop("profiler_windows_retaken"):
            print(f"{label} profiler window short: {line}", flush=True)
        if a.kernel == "trainf32":
            print(f"{label} f32 train step 64f@420: checked steps {res['checked_ms_step']:.1f} "
                  f"ms/step, peak {res['peak_gb']:.2f} GiB  [{card}]", flush=True)
            for setting in ("f32", "cudnn_tf32"):
                r = res[setting]
                ev = ", ".join(f"{x:.1f}" for x in r["events_ms"])
                host = ", ".join(f"{x:.1f}" for x in r["host_ms"])
                print(f"{label} f32 step [{setting}]: events {ev} ms (median "
                      f"{r['events_median_ms']:.1f}); host enqueue {host} ms  [{card}]",
                      flush=True)
                for p in r["profiled"]:
                    print(f"{label} profiled f32 step [{setting}]: wall {p['wall_ms']:.1f} ms, "
                          f"device busy {p['busy_ms']:.1f} ms (idle {p['idle']:.3f}), "
                          f"{p['kernels']} kernels, K1 device {p['k1_device_ms']:.3f} ms; device "
                          f"idle {p['idle_before_k1_ms']:.1f} ms before K1, "
                          f"{p['idle_in_k1_ms']:.1f} in its span, {p['idle_after_k1_ms']:.1f} of "
                          f"the {p['after_k1_ms']:.1f} after it; last kernel ends "
                          f"{p['device_past_host_ms']:.1f} ms after the host's last CUDA call"
                          f"  [{card}]", flush=True)
            continue
        if a.kernel in ("k1", "k1f32"):
            for r in res.pop("gemm_layers", []):
                print(f"{label} GEMM alone C={r['C']} M={r['M']} {r['layer']}: device "
                      f"{r['device_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms, plan {r['plan']}"
                      f"  [{card}]", flush=True)
            tot = {k: 0.0 for k in ("all", "gemm", "attn", "ln", "events")}
            for kind, r in res.items():
                print(f"{label} {kind}: rel_err {r['rel_err']:.3e}, device {r['all_device_ms']:.4f}"
                      f" ms = gemm {r['gemm_device_ms']:.4f} + attn {r['attn_device_ms']:.4f} + "
                      f"ln {r['ln_device_ms']:.4f}; events {r['events_ms']:.4f} ms  [{card}]",
                      flush=True)
                for k in ("all", "gemm", "attn", "ln"):
                    tot[k] += r["per"] * r[f"{k}_device_ms"]
                tot["events"] += r["per"] * r["events_ms"]
            unit = ("per 64f@420 f32 step (12 calls)" if a.kernel == "k1f32"
                    else "per V=2 forward at 224 px (12 calls)")
            print(f"{label} K1 {unit}: device {tot['all']:.3f} ms = gemm {tot['gemm']:.3f} + "
                  f"attn {tot['attn']:.3f} + ln {tot['ln']:.3f}; events {tot['events']:.3f} ms"
                  f"  [{card}]", flush=True)
            continue
        sums = [0.0, 0.0]
        for kind, r in res.items():
            rel = "" if r["rel_err"] is None else f"rel_err {r['rel_err']:.3e}, "
            print(f"{label} {kind}: {rel}device {r['device_ms']:.4f} ms, events "
                  f"{r['events_ms']:.4f} ms ({r['kernels_per_call']:.0f} device kernels per "
                  f"call, {r['all_kernels_device_ms']:.4f} ms together); SDPA device "
                  f"{r['sdpa_device_ms']:.4f} ms, events {r['sdpa_events_ms']:.4f} ms  [{card}]",
                  flush=True)
            sums[0] += r["device_ms"]
            sums[1] += r["sdpa_device_ms"]
        if a.kernel == "k5":
            print(f"{label} K5 per 32-frame prefill (32 layers x the 9 chunks): device "
                  f"{32 * sums[0]:.2f} ms, SDPA device {32 * sums[1]:.2f} ms  [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
