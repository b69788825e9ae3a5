"""Readings of a cell's control: the reference put in the program's place,
computed one precision below the configuration's (``reference/precision``),
judged by the cell's own comparison. A sound benchmark reads the control as
not correct. With ``--fault`` also the readings of the program with each
named fault of ``faults.py`` planted, each over a window of its own.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--seconds 4]
        [--fault serve_box_first_layer ...] [--no-control]

For each seed: the cell's set-up and a short window (the comparison samples
what the window served), then the comparison of the program, of the
control and of each fault, printed as one JSON line. The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import run  # noqa: E402  (sets the cache directories)
import faults as fault_fns  # noqa: E402
from harness import load_json, load_module, log  # noqa: E402


def readings(workload: str, seed: int, seconds: float, device=None, overrides=None,
             control: bool = True, faults=()):
    """{"program": {check: value}, "control": {...}, <fault>: {...}} of one
    seed."""
    import torch

    wl = load_json("workloads", workload + ".json")
    cfg = load_json("configs", wl["config"] + ".json")
    dev = torch.device(device or "cuda")
    ctx = run.Ctx(wl, cfg, seed, seconds, False, dev, overrides)
    driver = load_module("traffic", wl["traffic"])
    state = driver.setup(ctx)
    driver.window(ctx, state)

    def judged(name, ctl=False):
        t0 = time.perf_counter()
        out = {c.name: c.value for c in driver.check(ctx, state, control=ctl)}
        log(f"{name}: check took {time.perf_counter() - t0:.1f} s")
        return out

    out = {}
    if not faults:
        driver.release(ctx, state)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    out["program"] = judged("program")
    if control:
        out["control"] = judged("control", True)
    for name in faults:
        undo = getattr(fault_fns, name)(state)
        driver.window(ctx, state)
        out[name] = judged(name)
        undo()
    if faults:
        driver.release(ctx, state)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--fault", action="append", default=[])
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        r = readings(args.workload, seed, args.seconds, control=not args.no_control,
                     faults=args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
