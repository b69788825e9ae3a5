"""The per-layer metrics that read the program's own tracer
(``program_spans.py``), on a hand-built snapshot; each returns None where
the program has no tracer (a parent commit) or its session recorded
nothing."""

import sys
import types

import pytest

from harness import load_module

MS = 1_000_000


def _span(sid, name, start_ms, end_ms, parent=None, rid=None, syncs=0, dev_ms=None,
          attrs=None):
    d0, d1 = dev_ms or (start_ms, end_ms)
    return {"id": sid, "name": name, "parent": parent, "thread": 1, "rid": rid,
            "start_ns": start_ms * MS, "end_ns": end_ms * MS, "dev_start_ns": d0 * MS,
            "dev_end_ns": d1 * MS, "syncs": syncs, "attrs": attrs or {}}


SNAPSHOT = {"session": 3, "cuda": True, "counters": {"syncs": 99, "qa.decode_steps": 16},
            "spans": [
    # serving: two answered requests (the third's queue span has no request)
    _span(1, "vgqa.serve.request", 0, 1000, rid=1),
    _span(2, "vgqa.serve.queue", 0, 400, parent=1, rid=1),
    _span(3, "vgqa.serve.request", 0, 500, rid=2),
    _span(4, "vgqa.serve.queue", 0, 100, parent=3, rid=2),
    _span(5, "vgqa.serve.queue", 0, 700, rid=3),
    _span(6, "vgqa.serve.batch", 400, 900, syncs=5, attrs={"rids": [1, 2]}),
    _span(7, "vgqa.ground.prepare", 400, 410, parent=6, rid=1, syncs=1),
    _span(8, "vgqa.ground.prepare", 410, 420, parent=6, rid=2),
    _span(9, "vgqa.ground.launch", 420, 470, parent=6, rid=1, syncs=2),
    _span(10, "vgqa.sync", 430, 450, parent=9, rid=1, syncs=3),
    _span(11, "vgqa.ground.launch", 470, 480, parent=6, rid=2),
    _span(12, "vgqa.ground.fetch", 480, 490, parent=6, rid=1, syncs=2),
    # training: two steps, one log, a 2 s window
    _span(20, "vgqa.train.step", 0, 800),
    _span(21, "vgqa.sync", 100, 300, parent=20, syncs=1),
    _span(22, "vgqa.train.forward", 300, 500, parent=20, syncs=2),
    _span(23, "vgqa.train.step", 1000, 1600),
    _span(24, "vgqa.train.log", 1700, 1750, syncs=1),
    # QA: one call of four answers
    *[_span(30 + i, "vgqa.qa.vision", 0, 10, syncs=1) for i in range(4)],
    *[_span(40 + i, "vgqa.qa.prefill", 0, 10, syncs=1, dev_ms=(0, 100 * (i + 1)))
      for i in range(4)],
    _span(50, "vgqa.qa.decode", 0, 10, syncs=16, dev_ms=(5, 165)),
]}

EXPECTED = {
    "queue_wait_share.serve": 100.0 * (400 + 100) / (1000 + 500),
    "enqueue_ms_per_request.serve": (30 + 10) / 2,
    "syncs_per_request.serve": (1 + 2 + 3 + 2) / 2,
    "enqueue_share.train": 100.0 * ((800 - 200) + 600) / 2000,
    "syncs_per_step.train": (1 + 2 + 1) / 2,
    "prefill_ms_per_request.qa": 250.0,
    "decode_ms_per_step.qa": 160.0 / 16,
    "syncs_per_answer.qa": (4 + 4 + 16) / 4,
}
WINDOW = types.SimpleNamespace(window_s=2.0)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_a_snapshot(metric, monkeypatch):
    from vgqa_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "snapshot", lambda: SNAPSHOT)
    got = load_module("metrics", metric).read(WINDOW, None, None)
    assert got == pytest.approx(EXPECTED[metric])
    monkeypatch.setattr(trace, "snapshot", lambda: {"session": None, "cuda": False,
                                                     "spans": [], "counters": {}})
    assert load_module("metrics", metric).read(WINDOW, None, None) is None


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_without_a_tracer(metric, monkeypatch):
    import vgqa_tpu_torch.utils

    monkeypatch.delattr(vgqa_tpu_torch.utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "vgqa_tpu_torch.utils.trace", None)
    assert load_module("metrics", metric).read(WINDOW, None, None) is None
