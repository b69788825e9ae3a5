"""The reader of ``decode_graph_share.qa`` on hand-built snapshots of the
program's tracer: replays over forwards, and None where no forward was
counted or the program has no tracer."""

import sys
import types

import pytest

from harness import load_module

WINDOW = types.SimpleNamespace(window_s=2.0)
METRIC = "decode_graph_share.qa"


@pytest.mark.parametrize("counters,want", [
    ({"qa.decode.forwards": 15, "qa.decode.graph_replays": 15}, 100.0),
    ({"qa.decode.forwards": 16, "qa.decode.graph_replays": 12}, 75.0),
    ({"qa.decode.forwards": 16}, 0.0),
    ({"qa.decode.forwards": 0, "qa.decode.graph_replays": 0}, None),
    ({"qa.decode_steps": 16}, None),
])
def test_decode_graph_share_reader(counters, want, monkeypatch):
    """Replays over forwards; None with no forward counted (an engine
    without the counters counts none)."""
    from vgqa_tpu_torch.utils import trace

    snap = {"session": 1, "cuda": True, "spans": [], "counters": counters}
    monkeypatch.setattr(trace, "snapshot", lambda: snap)
    got = load_module("metrics", METRIC).read(WINDOW, None, None)
    assert got == (pytest.approx(want) if want is not None else None)


def test_decode_graph_share_without_a_tracer(monkeypatch):
    import vgqa_tpu_torch.utils

    monkeypatch.delattr(vgqa_tpu_torch.utils, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "vgqa_tpu_torch.utils.trace", None)
    assert load_module("metrics", METRIC).read(WINDOW, None, None) is None
