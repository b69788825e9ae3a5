"""Share of the traced QA calls in which no operation ran on the device."""

LAYER = "device"
UNIT = "%"
MOVES = "qa_answers_per_s"


def read(trace, ctx, state):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s) if trace.window_s > 0 else None
