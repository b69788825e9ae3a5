"""Share of the lockstep decode's forwards that ran as a CUDA graph replay:
counter ``qa.decode.graph_replays`` over ``qa.decode.forwards`` in the
traced calls. None where the program counts no forwards (a program without
the counters, or a traced part with no decode step)."""

import program_spans

LAYER = "QA engine"
UNIT = "%"
MOVES = "qa_answers_per_s"


def read(trace, ctx, state):
    sp = program_spans.load()
    if sp is None:
        return None
    forwards = sp.counters.get("qa.decode.forwards", 0)
    return 100.0 * sp.counters.get("qa.decode.graph_replays", 0) / forwards if forwards else None
