"""K2 (the encoder's window attention, eval) against its bound at the
served shapes: rows = 2 halves x T frames, S = 2 x (RESOLUTION / 32)^2 visual
tokens + MAX_QUERY_LEN text tokens, C = VSTG.HIDDEN."""

import math

import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "ground_clips_per_s"
K2 = r"window_attn_sm90_kernel<\d+, false>"


def read(trace, ctx, state):
    calls = trace.kernel_count(K2)
    seconds = trace.seconds_matching(K2)
    if not calls or not seconds:
        return None
    v = ctx.cfg_values
    hw = math.ceil(v["INPUT.RESOLUTION"] / 32) ** 2
    S = 2 * hw + v["INPUT.MAX_QUERY_LEN"]
    per_call = roofline.k2_bound_s(2 * v["INPUT.TRAIN_SAMPLE_NUM"], S, v["MODEL.VSTG.HIDDEN"])
    return 100.0 * calls * per_call / seconds
