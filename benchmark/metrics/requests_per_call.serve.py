"""Requests per call of the grounding coalescer's batch runner in the traced
window (the harness counts the requests handed to each call)."""

LAYER = "serving"
UNIT = "requests"
MOVES = "ground_clips_per_s"


def read(trace, ctx, state):
    calls = trace.counters.get("calls") or []
    return sum(calls) / len(calls) if calls else None
