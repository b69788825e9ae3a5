"""K6 (int4_matmul) on one GPU: this tree against another checkout (for
example the parent commit unpacked by ``git archive``), and every launch
plan of this tree's kernel.

    python3 chip_k6.py [--other DIR]

Each run is its own process, in the order other, this, this, other, so
that both trees see the card alike. A run imports ``vgqa_tpu_torch`` and
``chip_smoke`` from its tree and reports the device time of one int4
token (224 products at M = 1) under the profiler and the host time per
call (``int4_host_us`` of this tree's ``chip_smoke.py``, on the run's own
wrapper); the first run of each tree also runs the tree's ``check_int4``
(the kernel against its plain version at the four projection shapes x
M = 1, 2, 64; CUDA-event times of kernel, plain version and library call).
The first run of this tree then launches every plan the kernel takes (nt,
wk, kg) at each projection shape and M = 1, 16 and 64 through the C entry
point, checks each against the plain version and times it under the
profiler, and marks the plan that ``_plan`` picks. The card line
(``nvidia-smi --query-gpu=name,power.limit``) is printed first. Any
failure exits non-zero.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def plan_sweep(cs, dev, g, reps=20) -> list:
    import torch
    from vgqa_tpu_torch.ops.kernels import build
    from vgqa_tpu_torch.ops.kernels.int4_matmul import _plan, int4_matmul_reference

    lib = build.load_library()
    rows = []
    for K, N in sorted({(k, n) for k, n, _ in cs.QA_PROJ}):
        n_g = K // 128
        n2 = n_g // 2
        packed = torch.randint(-128, 128, (K // 2, N), generator=g, device=dev,
                               dtype=torch.int32).to(torch.int8)
        scale = torch.rand(n_g, N, generator=g, device=dev) * 0.01
        for M in (1, 16, 64):
            x = torch.randn(M, K, generator=g, device=dev).bfloat16()
            ref = int4_matmul_reference(x, packed, scale)
            y = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
            mt = 1 if M <= 8 else 2 if M <= 16 else 4 if M <= 32 else 8
            p = _plan(M, K, N, n_g)
            here = []
            for nt in (n for n in (1, 2, 4) if n * mt <= 8):
                for wk in (w for w in (1, 2, 4) if n2 % w == 0):
                    runs = n2 // wk
                    for kg in (d for d in range(1, runs + 1) if runs % d == 0 and runs // d <= 8):
                        def call(nt=nt, wk=wk, kg=kg):
                            stream = torch._C._cuda_getCurrentRawStream(dev.index)
                            build.check(lib.vgqa_int4_matmul(
                                x.data_ptr(), packed.data_ptr(), scale.data_ptr(), y.data_ptr(),
                                M, K, N, n_g, nt, wk, kg, stream), "plan sweep")

                        y.zero_()
                        call()
                        torch.cuda.synchronize()
                        rel = cs.rel_err(y, ref)[0]
                        if not rel < cs.REL_TOL:
                            raise AssertionError(f"plan nt={nt} wk={wk} kg={kg} at {M}x{K}x{N}: "
                                                 f"rel_err {rel}")
                        _, _, _, top = cs.profile_step(lambda: [call() for _ in range(reps)])
                        us = sum(v for name, v in top if "int4" in name) / reps
                        here.append({"M": M, "K": K, "N": N, "nt": nt, "wk": wk, "kg": kg,
                                     "blocks": -(-N // (16 * nt)) * (runs // kg),
                                     "device_us": us, "rel_err": rel,
                                     "chosen": (nt, wk, kg) == (p.nt, p.wk, p.kg)})
            best = min(here, key=lambda r: r["device_us"])
            pick = next(r for r in here if r["chosen"])
            for r in sorted(here, key=lambda r: r["device_us"]):
                print(f"plan M={M} K={K} N={N} nt={r['nt']} wk={r['wk']} kg={r['kg']} blocks "
                      f"{r['blocks']}: {r['device_us']:.2f} us{'  <- _plan' if r['chosen'] else ''}")
            print(f"plan sweep M={M} K={K} N={N}: {len(here)} plans, {min(r['device_us'] for r in here):.2f}"
                  f"-{max(r['device_us'] for r in here):.2f} us; _plan's {pick['device_us']:.2f} us, "
                  f"{pick['device_us'] / best['device_us']:.3f}x the best", flush=True)
            rows += here
    return rows


def child(tree: str, first: bool, sweep: bool) -> dict:
    sys.path.insert(0, tree)
    import torch

    import chip_smoke as cs                      # the tree's own
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    torch.backends.cuda.matmul.allow_tf32 = False
    from vgqa_tpu_torch.ops.kernels import build

    build.load_library()
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    out = {"tree": tree}
    if first:
        out["rows"] = cs.check_int4(dev, g)
    out["device_ms_per_token"] = cs.int4_token_device_ms(dev, g)
    out["host_us_per_call"] = here.int4_host_us(dev, g)
    if sweep:
        out["sweep"] = plan_sweep(here, dev, g)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", help="another checkout to measure in turns with this one")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--first", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--sweep", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print("K6RESULT " + json.dumps(child(a.child, a.first, a.sweep)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    order = [(HERE, "this", True), (HERE, "this", False)]
    if a.other:
        other = os.path.abspath(a.other)
        order = [(other, "other", True)] + order + [(other, "other", False)]
    results = []
    for tree, label, first in order:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", tree]
        cmd += ["--first"] if first else []
        cmd += ["--sweep"] if first and label == "this" else []
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=tree)
        sys.stdout.write(proc.stdout)
        if proc.returncode != 0:
            sys.stdout.write(proc.stderr[-6000:])
            print(f"run {label} ({tree}) failed with {proc.returncode}", flush=True)
            return 1
        res = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("K6RESULT ")][-1][9:])
        results.append(dict(res, label=label))
    for r in results:
        print(f"{r['label']}: device {r['device_ms_per_token']:.3f} ms/token, host "
              f"{r['host_us_per_call']:.2f} us/call  [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
