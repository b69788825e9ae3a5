"""BENCHMARK.json against the contract's shapes, and every file it names
found by name."""

import json
import os
import re

import pytest

from harness import load_json, load_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


ENTRY_KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}


@pytest.mark.parametrize("kind", sorted(ENTRY_KEYS))
def test_entry_keys_and_lines(kind):
    """Every entry has just the contract's keys, and each line of text
    (``why``, ``layer``, ``source``) has 1 to 200 characters, one line, no tab."""
    needed, optional = ENTRY_KEYS[kind]
    for e in BENCH[kind]:
        assert needed <= set(e) <= needed | optional, (e["name"], sorted(e))
        for key in ("why", "layer", "source"):
            if key in e:
                text = e[key]
                assert 1 <= len(text) <= 200 and not re.search(r"[\t\n\r]", text), (e["name"], key)


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_end_to_end_bounds():
    names = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_has_its_files():
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        spec = load_json("workloads", w["name"] + ".json")
        assert spec["config"] == w["config"] and spec["traffic"] == w["traffic"]
        assert spec["chips"] == w["chips"] and spec["why"] == w["why"]
        load_json("configs", w["config"] + ".json")
        driver = load_module("traffic", w["traffic"])
        for fn in ("setup", "window", "release", "check"):
            assert callable(getattr(driver, fn))
        e2e = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert len(e2e) >= 2
        assert any(w["name"] in m.get("workloads", []) for m in BENCH["per_layer"])


def test_configs_match_their_files():
    for c in BENCH["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        spec = load_json("configs", c["name"] + ".json")
        assert spec["source"] == c["source"] and spec["reduced"] == c["reduced"]
        assert spec["why"] == c["why"]


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_per_layer_reader(metric):
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    reader = load_module("metrics", metric)
    assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"])
    e2e = {x["name"]: x for x in BENCH["end_to_end"]}
    for cell in m["workloads"]:
        assert cell in e2e[m["moves"]].get("workloads", [cell])
