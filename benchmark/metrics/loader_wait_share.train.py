"""Share of the traced window the trainer spent waiting for the loader's
next batch (``Trainer.step_log``'s per-step loader wait, summed)."""

LAYER = "data path"
UNIT = "%"
MOVES = "train_clips_per_s"


def read(trace, ctx, state):
    wait = trace.counters.get("loader_wait_s")
    return None if wait is None or trace.window_s <= 0 else 100.0 * wait / trace.window_s
