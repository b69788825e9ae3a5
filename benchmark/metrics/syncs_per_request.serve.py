"""Host waits on the device per grounding request: the synchronizing CUDA
calls counted under the ``vgqa.ground.*`` spans over the requests prepared
(``vgqa.ground.prepare`` spans)."""

import program_spans

LAYER = "two-pass forward"
UNIT = "syncs"
MOVES = "ground_clips_per_s"


def read(trace, ctx, state):
    sp = program_spans.load()
    if sp is None:
        return None
    n = len(sp.named("vgqa.ground.prepare"))
    return sp.syncs_under(lambda name: name.startswith("vgqa.ground.")) / n if n else None
