"""Host milliseconds per request spent enqueueing the grounding forward:
the self time of the ``vgqa.ground.launch`` spans (their ``vgqa.sync``
waits and other children left out) over the requests prepared
(``vgqa.ground.prepare`` spans; a coalesced launch covers several)."""

import program_spans

LAYER = "two-pass forward"
UNIT = "ms"
MOVES = "ground_clips_per_s"


def read(trace, ctx, state):
    sp = program_spans.load()
    if sp is None:
        return None
    n = len(sp.named("vgqa.ground.prepare"))
    launches = sp.named("vgqa.ground.launch")
    return 1e3 * sum(sp.self_s(s) for s in launches) / n if n and launches else None
