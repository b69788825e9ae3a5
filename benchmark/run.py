"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``benchmark/workloads/<cell>.json``; it names its configuration
(``benchmark/configs/<config>.json``) and the traffic driver that runs it
(``benchmark/traffic/<traffic>.py``). Set-up builds the program from the
seed and warms up the cell's shapes; the window then runs the traffic for
``--seconds``; after it, the peak device memory is read, the program is
freed, and the check compares what the window produced with the plain
reference (``benchmark/reference/``). With ``--trace 0`` the result line
carries the cell's end-to-end metrics; with ``--trace 1`` a profiled part
of the window gives its per-layer metrics (``benchmark/metrics/<name>.py``),
the device's busy and window seconds and a breakdown. The last line of
standard output is the result; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
OUT = os.path.join(HERE, "out")
# the program's kernel caches at fixed paths inside the checkout, so that a
# second run of a cell in the same checkout builds nothing
os.environ["TRITON_CACHE_DIR"] = os.path.join(OUT, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(OUT, "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(OUT, "inductor")
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"
for p in (HERE, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import (benchmark_json, forbidden_modules, load_json, load_module,  # noqa: E402
                     log)


class Ctx:
    """What a traffic driver is given: the cell, its configuration, the run's
    seed, window length, trace flag and device; ``overrides`` (tests) shrink
    the configuration and the traffic."""

    def __init__(self, workload, config, seed, seconds, trace, device, overrides=None,
                 fault=None):
        self.workload = workload
        self.config = config
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.overrides = overrides or {}
        self.params = dict(workload["params"], **self.overrides.get("params", {}))
        self.cfg_values = dict(config.get("cfg", {}), **self.overrides.get("cfg", {}))
        self.fault = fault

    def plant(self, state) -> None:
        """Tests: plant a fault in the program the driver just built."""
        if self.fault is not None:
            self.fault(state)


def _metrics_for(bench, name: str, trace: bool):
    if not trace:
        return [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e = {m["name"] for m in bench["end_to_end"] if name in m.get("workloads", [name])}
    return [m for m in bench["per_layer"]
            if name in m.get("workloads", [name] if m["moves"] in e2e else [])]


def run(workload: str, seed: int, seconds: float, trace: bool, device=None,
        overrides=None, fault=None):
    """One run; returns (result dict, exit code). ``device`` given (tests)
    skips the look for cards; ``fault`` (tests) is called with the driver's
    state once the program is built, before its first step or request, to
    break the timed path underneath."""
    import torch

    wl = load_json("workloads", workload + ".json")
    if device is None:
        need = int(wl["chips"])
        if not torch.cuda.is_available() or torch.cuda.device_count() < need:
            log(f"{workload} needs {need} CUDA device(s); found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return None, 2
        device = torch.device("cuda", 0)
    bench = benchmark_json()
    cfg = load_json("configs", wl["config"] + ".json")
    ctx = Ctx(wl, cfg, seed, seconds, trace, torch.device(device), overrides, fault)
    driver = load_module("traffic", wl["traffic"])
    on_card = ctx.device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    state = driver.setup(ctx)
    setup_s = time.time() - T_START
    win = driver.window(ctx, state)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    driver.release(ctx, state)
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks = driver.check(ctx, state)
    correct = all(c.ok for c in checks) and bool(checks)

    metrics = {}
    values = dict(win["metrics"], setup_s=setup_s)
    for m in _metrics_for(bench, workload, trace):
        if trace:
            reader = load_module("metrics", m["name"])
            v = reader.read(win["trace"], ctx, state)
        else:
            v = values.get(m["name"])
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    if on_card:
        dev_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                    "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    result = {"correct": correct, "attempted": win["attempted"], "failed": win["failed"],
              "metrics": metrics, "device": dev_info}
    if trace:
        tr = win["trace"]
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": [[n, s] for n, s in tr.device_ops],
                               "idle_gaps": [[n, s] for n, s in tr.idle_gaps]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result, 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "vgqa_tpu_torch")):
        log("the program (vgqa_tpu_torch) is not in this checkout")
        return 2
    result, rc = run(args.workload, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return rc
    bad = forbidden_modules()
    if bad:
        log("forbidden modules loaded: " + ", ".join(bad))
        return 3
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
