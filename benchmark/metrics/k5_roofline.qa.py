"""K5 (causal GQA attention of the chunked prefill) against its bound: each
traced request's 1,024-token chunks, summed over the decoder's layers, over
K5's device time."""

import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "qa_answers_per_s"
K5 = r"flash_gqa_sm90_kernel"


def read(trace, ctx, state):
    lengths = trace.counters.get("prompt_lengths")
    seconds = trace.seconds_matching(K5)
    if not lengths or not seconds:
        return None
    llm = ctx.config["llm"]
    bound = sum(roofline.k5_prefill_bound_s(
        n, 1024, ctx.config["max_seq_len"], llm["num_layers"], H=llm["num_heads"],
        Hkv=llm["num_kv_heads"], D=llm["hidden_size"] // llm["num_heads"]) for n in lengths)
    return 100.0 * bound / seconds
