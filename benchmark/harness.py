"""What every cell shares: reading the benchmark's files by name, the
device trace and its reduction, percentiles and the forbidden-module check."""

from __future__ import annotations

import bisect
import importlib.util
import json
import os
import re
import sys
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "vgqa_tpu")


def load_json(*parts: str) -> Dict[str, Any]:
    with open(os.path.join(BENCH, *parts)) as f:
        return json.load(f)


def benchmark_json() -> Dict[str, Any]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = os.path.join(BENCH, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``vgqa_tpu_torch`` is not ``vgqa_tpu``)."""
    names = sys.modules if modules is None else modules
    return sorted({n for n in names if n.split(".")[0] in FORBIDDEN})


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class Check:
    name: str
    value: float
    limit: float

    def __post_init__(self):
        self.value, self.limit = float(self.value), float(self.limit)

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


@dataclass
class TraceData:
    """The device trace of one traced window."""
    window_s: float
    busy_s: float
    n_kernels: int                          # kernels in the window
    by_name: Dict[str, List[float]]         # name -> [count, seconds]
    idle_gaps: List[tuple]                  # (host context, seconds)
    device_ops: List[tuple]                 # (name, seconds), the top ones
    counters: Dict[str, Any] = field(default_factory=dict)

    def kernel_count(self, pattern: Optional[str] = None) -> int:
        """Kernels in the window, or those whose name matches ``pattern``."""
        if pattern is None:
            return self.n_kernels
        rx = re.compile(pattern)
        return sum(int(v[0]) for n, v in self.by_name.items() if rx.search(n))

    def seconds_matching(self, pattern: str) -> float:
        """Device seconds of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(v[1] for n, v in self.by_name.items() if rx.search(n))


class DeviceTrace:
    """``with DeviceTrace() as tr:`` profiles the block on the card
    (torch.profiler, CPU and CUDA activities); ``tr.data`` is the
    reduction. The window is fenced by device synchronisations."""

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch

        torch.cuda.synchronize()
        window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self.data = reduce_trace(events, window_s)
        return False


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAMED_GAPS = 300


def reduce_trace(events: List[dict], window_s: float) -> TraceData:
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("user_annotation", "cpu_op")]
    n_kernels = sum(e.get("cat") == "kernel" for e in dev)
    by_name: Dict[str, List[float]] = {}
    for e in dev:
        v = by_name.setdefault(e["name"], [0, 0.0])
        v[0] += 1
        v[1] += float(e.get("dur", 0.0)) / 1e6
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in dev)
    merged = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) / 1e6
    # idle gaps between device work: the longest NAMED_GAPS named by the
    # innermost host operation or harness span running at the gap's middle
    # ("host" where none runs), the rest summed as "short gaps"
    annotated = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
                       for e in host)
    starts = [a[0] for a in annotated]
    pairs = sorted(((s1 - t0, 0.5 * (t0 + s1)) for (_, t0), (s1, _)
                    in zip(merged[:-1], merged[1:])), reverse=True)
    gaps: Dict[str, float] = {}
    for rank_i, (length, mid) in enumerate(pairs):
        key = "short gaps"
        if rank_i < NAMED_GAPS:
            best = None
            i = bisect.bisect_right(starts, mid) - 1
            for a, b, name in annotated[max(0, i - 4000):i + 1]:
                if b >= mid and (best is None or b - a < best[0]):
                    best = (b - a, name)
            key = best[1] if best else "host"
        gaps[key] = gaps.get(key, 0.0) + length / 1e6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    top = sorted(((n, v[1]) for n, v in by_name.items()), key=lambda kv: -kv[1])[:10]
    return TraceData(window_s, busy, n_kernels, by_name, idle, top)
