"""An answer's share of the card's dense bf16 peak: the FLOPs the model
needs for each traced answer (vision, prefill of its own prompt, decode;
``flops.py``), summed over the traced answers, over the traced seconds,
over 989 TFLOP/s."""

import flops
import roofline

LAYER = "model"
UNIT = "%"
MOVES = "qa_answers_per_s"


def read(trace, ctx, state):
    prompts = trace.counters.get("prompt_lengths")
    if not prompts:
        return None
    g = state["ref"]
    p = ctx.params
    total = sum(flops.qa_answer_flops(g.vision.g, g.llm.g, p["frames"], n, p["new_tokens"])
                for n in prompts)
    return 100.0 * total / trace.window_s / roofline.PEAK_BF16
