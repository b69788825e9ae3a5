"""The Hopper attention kernels on one GPU: this tree against another
checkout (for example the parent commit unpacked by ``git archive``), in
turns.

    python3 chip_k4.py [--kernel k4|k2|k5] [--other DIR] [--sass]

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


def child(tree: str, kernel: str) -> dict:
    sys.path.insert(0, tree)
    cs = _smoke()
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
    ap.add_argument("--kernel", choices=("k4", "k2", "k5"), default="k4")
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
