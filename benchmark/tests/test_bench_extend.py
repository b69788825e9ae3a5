"""A later change adds a cell and a per-layer metric as new files only."""

import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = r"""
import json, sys
sys.path.insert(0, "benchmark")
import run
from harness import benchmark_json, load_json, load_module
bench = benchmark_json()
wl = load_json("workloads", "extra_cell.json")
driver = load_module("traffic", wl["traffic"])
per_layer = [m["name"] for m in run._metrics_for(bench, "extra_cell", True)]
e2e = [m["name"] for m in run._metrics_for(bench, "extra_cell", False)]
reader = load_module("metrics", "extra_metric.serve")
print(json.dumps({"per_layer": per_layer, "e2e": e2e, "driver": driver.__name__,
                  "value": reader.read(None, None, None)}))
"""


def test_new_cell_and_metric_are_files_only(tmp_path):
    copy = tmp_path / "checkout"
    os.makedirs(copy)
    shutil.copytree(os.path.join(ROOT, "benchmark"), copy / "benchmark",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy / "BENCHMARK.json")
    before = {p: open(p, "rb").read() for p in (copy / "benchmark").rglob("*.py")}
    wl = json.load(open(copy / "benchmark" / "workloads" / "vstg420_serve_c4.json"))
    wl["name"] = "extra_cell"
    wl["params"]["clients"] = 8
    json.dump(wl, open(copy / "benchmark" / "workloads" / "extra_cell.json", "w"))
    (copy / "benchmark" / "metrics" / "extra_metric.serve.py").write_text(
        'LAYER = "device"\nUNIT = "%"\nMOVES = "ground_clips_per_s"\n\n\n'
        'def read(trace, ctx, state):\n    return 42.0\n')
    bench = json.load(open(copy / "BENCHMARK.json"))
    bench["workloads"].append({"name": "extra_cell", "config": wl["config"],
                               "traffic": wl["traffic"], "chips": 1, "why": wl["why"]})
    for m in bench["end_to_end"]:
        if "vstg420_serve_c4" in m.get("workloads", []):
            m["workloads"].append("extra_cell")
    bench["per_layer"].append({"name": "extra_metric.serve", "unit": "%", "better": "lower",
                               "source": "device_trace", "layer": "device",
                               "moves": "ground_clips_per_s", "workloads": ["extra_cell"]})
    json.dump(bench, open(copy / "BENCHMARK.json", "w"))
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=copy, capture_output=True,
                         text=True, check=True, timeout=300)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["per_layer"] == ["extra_metric.serve"]
    assert set(got["e2e"]) == {"ground_clips_per_s", "ground_latency_p95_s", "setup_s"}
    assert got["value"] == 42.0
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
