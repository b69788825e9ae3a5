"""Host waits on the device per train step: the synchronizing CUDA calls
counted under the ``vgqa.train.step`` and ``vgqa.train.log`` spans over the
steps traced."""

import program_spans

LAYER = "train step"
UNIT = "syncs"
MOVES = "train_clips_per_s"


def read(trace, ctx, state):
    sp = program_spans.load()
    if sp is None:
        return None
    n = len(sp.named("vgqa.train.step"))
    under = sp.syncs_under(lambda name: name in ("vgqa.train.step", "vgqa.train.log"))
    return under / n if n else None
