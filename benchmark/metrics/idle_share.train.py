"""Share of the traced training window in which no operation ran on the
device."""

LAYER = "device"
UNIT = "%"
MOVES = "train_clips_per_s"


def read(trace, ctx, state):
    return 100.0 * (1.0 - trace.busy_s / trace.window_s) if trace.window_s > 0 else None
