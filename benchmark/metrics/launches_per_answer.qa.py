"""Device kernels per answer in the traced chat_batch calls."""

LAYER = "QA engine"
UNIT = "launches"
MOVES = "qa_answers_per_s"


def read(trace, ctx, state):
    n = trace.counters.get("answers")
    return trace.kernel_count() / n if n else None
