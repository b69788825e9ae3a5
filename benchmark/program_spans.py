"""The program's own spans and counters, for the per-layer metrics that
read them: ``vgqa_tpu_torch.utils.trace.snapshot()`` of the newest traced
session (a ``--trace 1`` run's profiled part turns the program's tracer on).

``load()`` is None where the program has no tracer or the session recorded
nothing, so a reader returns None there and its metric is left out of the
result line."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

SYNC = "vgqa.sync"


class Spans:
    """One session's spans (host and device intervals in ns, ``syncs``,
    ``parent`` ids) and counters."""

    def __init__(self, snap: Dict[str, Any]):
        self.spans: List[Dict[str, Any]] = list(snap.get("spans") or [])
        self.counters: Dict[str, Any] = dict(snap.get("counters") or {})
        self.by_id = {s["id"]: s for s in self.spans}
        self.children: Dict[Any, List[Dict[str, Any]]] = {}
        for s in self.spans:
            self.children.setdefault(s["parent"], []).append(s)

    def named(self, name: str) -> List[Dict[str, Any]]:
        return [s for s in self.spans if s["name"] == name]

    @staticmethod
    def host_s(s) -> float:
        return (s["end_ns"] - s["start_ns"]) / 1e9

    @staticmethod
    def device_s(s) -> float:
        return (s["dev_end_ns"] - s["dev_start_ns"]) / 1e9

    def descendants(self, s) -> List[Dict[str, Any]]:
        out, todo = [], list(self.children.get(s["id"], []))
        while todo:
            c = todo.pop()
            out.append(c)
            todo.extend(self.children.get(c["id"], []))
        return out

    def self_s(self, s) -> float:
        """Host seconds of ``s`` that none of its children covers."""
        from vgqa_tpu_torch.utils import trace

        return trace.self_time(s, self.children.get(s["id"], []))

    def sync_wait_s(self, s) -> float:
        """Host seconds of the ``vgqa.sync`` spans under ``s``."""
        return sum(self.host_s(d) for d in self.descendants(s) if d["name"] == SYNC)

    def syncs_under(self, match: Callable[[str], bool]) -> int:
        """Syncs counted against the spans whose name ``match``es and
        against every span below them, each span once."""
        total = 0
        for s in self.spans:
            p = s
            while p is not None and not match(p["name"]):
                p = self.by_id.get(p["parent"])
            if p is not None:
                total += int(s.get("syncs", 0))
        return total


def load() -> Optional[Spans]:
    try:
        from vgqa_tpu_torch.utils import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    if not snap or not (snap.get("spans") or snap.get("counters")):
        return None
    return Spans(snap)
