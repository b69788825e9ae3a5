"""Host waits on the device per answer: the synchronizing CUDA calls
counted under the ``vgqa.qa.*`` spans over the answers (``vgqa.qa.prefill``
spans, one per request)."""

import program_spans

LAYER = "QA engine"
UNIT = "syncs"
MOVES = "qa_answers_per_s"


def read(trace, ctx, state):
    sp = program_spans.load()
    if sp is None:
        return None
    n = len(sp.named("vgqa.qa.prefill"))
    return sp.syncs_under(lambda name: name.startswith("vgqa.qa.")) / n if n else None
