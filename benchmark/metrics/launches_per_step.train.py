"""Device kernels per training step in the traced window."""

LAYER = "train step"
UNIT = "launches"
MOVES = "train_clips_per_s"


def read(trace, ctx, state):
    steps = trace.counters.get("steps")
    return trace.kernel_count() / steps if steps else None
