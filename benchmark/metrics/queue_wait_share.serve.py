"""Share of the answered requests' time spent queued in the coalescer:
the ``vgqa.serve.queue`` spans over the ``vgqa.serve.request`` spans of the
requests answered in the traced session (the program's tracer)."""

import program_spans

LAYER = "serving"
UNIT = "%"
MOVES = "ground_latency_p95_s"


def read(trace, ctx, state):
    sp = program_spans.load()
    if sp is None:
        return None
    requests = sp.named("vgqa.serve.request")
    rids = {r["rid"] for r in requests}
    total = sum(sp.host_s(r) for r in requests)
    queued = sum(sp.host_s(q) for q in sp.named("vgqa.serve.queue") if q["rid"] in rids)
    return 100.0 * queued / total if total > 0 else None
