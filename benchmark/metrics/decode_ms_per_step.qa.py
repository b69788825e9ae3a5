"""Device milliseconds per lockstep decode step: the device interval of the
``vgqa.qa.decode`` spans over the steps they ran (``qa.decode_steps``)."""

import program_spans

LAYER = "QA engine"
UNIT = "ms"
MOVES = "qa_answers_per_s"


def read(trace, ctx, state):
    sp = program_spans.load()
    if sp is None:
        return None
    steps = sp.counters.get("qa.decode_steps", 0)
    decodes = sp.named("vgqa.qa.decode")
    return 1e3 * sum(sp.device_s(s) for s in decodes) / steps if steps and decodes else None
