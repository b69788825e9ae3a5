"""Share of the traced window the host spent inside the train step:
the ``vgqa.train.step`` spans' host time less their ``vgqa.sync`` waits,
over the window's seconds."""

import program_spans

LAYER = "train step"
UNIT = "%"
MOVES = "train_clips_per_s"


def read(trace, ctx, state):
    sp = program_spans.load()
    steps = sp.named("vgqa.train.step") if sp is not None else []
    if not steps or trace.window_s <= 0:
        return None
    busy = sum(sp.host_s(s) - sp.sync_wait_s(s) for s in steps)
    return 100.0 * busy / trace.window_s
