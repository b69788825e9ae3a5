"""Device milliseconds of one request's prefill: the device interval of
the ``vgqa.qa.prefill`` spans (prompt embedding, the chunked prefill, the
int8 cache fill and the copy of its row into the batch cache) per span."""

import program_spans

LAYER = "QA engine"
UNIT = "ms"
MOVES = "qa_answers_per_s"


def read(trace, ctx, state):
    sp = program_spans.load()
    prefills = sp.named("vgqa.qa.prefill") if sp is not None else []
    return 1e3 * sum(sp.device_s(s) for s in prefills) / len(prefills) if prefills else None
