"""K4 (flash_mha) on one GPU: this tree against another checkout (for
example the parent commit unpacked by ``git archive``), in turns.

    python3 chip_k4.py [--other DIR] [--sass]

Each timing run is its own process, in the order other, this, this, other,
so that both trees see the card alike. A run imports ``vgqa_tpu_torch`` and
``chip_smoke`` from its tree and times K4 at one InternViT call ([8 tiles,
1025, 16 x 64] as slices of one fused qkv tensor), maskless and masked:
the error against the plain version, CUDA-event ms per call over 50
back-to-back calls and device ms per call under the profiler (20 calls),
and SDPA (``scaled_dot_product_attention``, the yardstick; the port never
calls it) the same way in the same process. Device time is read by this
tree's ``chip_smoke.device_kernels`` in every run, beside ``flash_mha``'s
own launch counter.

``--sass`` (with ``--other``) compiles both trees' ``csrc/flash_attention.cu``
and compares K3's forward and K5 (``attn_fwd_kernel<32, 2>`` and
``<128, 1>``) line for line after normalising constant-bank offsets, and
counts HGMMA, UTMALDG and MUFU.EX2 in this tree's
``csrc/flash_mha_sm90.cu``. The card line (``nvidia-smi --query-gpu=name,
power.limit``) is printed first. Any failure exits non-zero.
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
T, L, H, D = 8, 1025, 16, 64


def _inputs():
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn(T, L, 3 * H * D, generator=g, device=dev).bfloat16()
    q, k, v = qkv.split(H * D, dim=-1)
    mask = torch.rand(T, L, generator=g, device=dev) > 0.2
    mask[:, 0] = True
    return q, k, v, mask


# K4's device kernel in this tree, and in trees from before its Hopper redesign
K4_KERNELS = ("flash_mha_sm90_kernel", "attn_fwd_kernel<64")


def child(tree: str) -> dict:
    sys.path.insert(0, tree)
    import torch

    from vgqa_tpu_torch.ops.kernels.flash_attention import flash_mha, flash_mha_reference

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    def device(fn):
        # (device kernels per call, K4's device ms per call, all kernels' ms per call)
        n, _, k4_ms, all_ms = cs.device_kernels(fn, calls=20, names=K4_KERNELS,
                                                counter=lambda: flash_mha.launches)
        return n, k4_ms, all_ms

    q, k, v, mask = _inputs()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for masked in (False, True):
        m = mask if masked else None
        rel = cs.rel_err(flash_mha(q, k, v, H, key_mask=m),
                         flash_mha_reference(q.float(), k.float(), v.float(), H, key_mask=m))[0]
        ev = cs.cuda_ms(lambda: flash_mha(q, k, v, H, key_mask=m), reps=50)
        n, dev_ms, all_ms = device(lambda: flash_mha(q, k, v, H, key_mask=m))

        def heads(t):
            return t.reshape(T, L, H, D).transpose(1, 2)

        am = None if m is None else m[:, None, None, :]

        def library():
            return sdpa(heads(q), heads(k), heads(v), attn_mask=am)

        lib_ev = cs.cuda_ms(library, reps=50)
        lib_dev = cs.device_kernels(library, calls=20)[3]
        if not rel < cs.REL_TOL:
            raise AssertionError(f"flash_mha masked={masked}: rel_err {rel}")
        out["masked" if masked else "maskless"] = {
            "rel_err": rel, "events_ms": ev, "device_ms": dev_ms, "kernels_per_call": n,
            "all_kernels_device_ms": all_ms,
            "sdpa_events_ms": lib_ev, "sdpa_device_ms": lib_dev}
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
    csrc = os.path.join("vgqa_tpu_torch", "csrc")
    theirs = _sass(os.path.join(other, csrc, "flash_attention.cu"), os.path.join(other, csrc))
    ours = _sass(os.path.join(HERE, csrc, "flash_attention.cu"), os.path.join(HERE, csrc))
    same = True
    for inst in ("attn_fwd_kernelILi32ELi2E", "attn_fwd_kernelILi128ELi1E"):
        a = [v for n, v in theirs.items() if inst in n]
        b = [v for n, v in ours.items() if inst in n]
        ok = len(a) == len(b) == 1 and a[0] == b[0]
        same &= ok
        print(f"SASS {inst}: {len(a[0]) if a else 0} vs {len(b[0]) if b else 0} instructions, "
              f"identical after normalising constant-bank offsets: {ok}", flush=True)
    for name, ins in _sass(os.path.join(HERE, csrc, "flash_mha_sm90.cu"),
                           os.path.join(HERE, csrc)).items():
        ops = [i.split()[1] if i.startswith("@") else i.split()[0] for i in ins if i]
        print(f"SASS {name}: {len(ins)} instructions; HGMMA "
              f"{sum(o.startswith('HGMMA') for o in ops)}, UTMALDG "
              f"{sum(o.startswith('UTMALDG') for o in ops)}, MUFU.EX2 "
              f"{sum(o.startswith('MUFU.EX2') for o in ops)}", flush=True)
    return same


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="another checkout to measure in turns with this one")
    ap.add_argument("--sass", action="store_true", help="compare K3-forward / K5 SASS with --other")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print("K4RESULT " + json.dumps(child(a.child)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    if a.sass and a.other and not sass_report(os.path.abspath(a.other)):
        print("K3's forward or K5 compiled to other code", flush=True)
        return 1
    order = [(HERE, "this"), (HERE, "this")]
    if a.other:
        other = os.path.abspath(a.other)
        order = [(other, "other")] + order + [(other, "other")]
    for tree, label in order:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree],
                              capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            sys.stdout.write(proc.stdout + proc.stderr[-6000:])
            print(f"run {label} ({tree}) failed with {proc.returncode}", flush=True)
            return 1
        res = json.loads([ln for ln in proc.stdout.splitlines()
                          if ln.startswith("K4RESULT ")][-1][9:])
        for line in res.pop("profiler_windows_retaken"):
            print(f"{label} profiler window short: {line}", flush=True)
        for kind, r in res.items():
            print(f"{label} K4 [128, 1025, 64] {kind}: rel_err {r['rel_err']:.3e}, device "
                  f"{r['device_ms']:.4f} ms, events {r['events_ms']:.4f} ms "
                  f"({r['kernels_per_call']:.0f} device kernels per call, "
                  f"{r['all_kernels_device_ms']:.4f} ms together); SDPA device "
                  f"{r['sdpa_device_ms']:.4f} ms, events {r['sdpa_events_ms']:.4f} ms  [{card}]",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
