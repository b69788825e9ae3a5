"""K3 in float32 (the encoder's training attention, forward and backward)
against its bound at the FFMA rate: rows = T frames, 8 heads of 32, S =
2 x (RESOLUTION / 32)^2 + MAX_QUERY_LEN tokens; calls counted by the forward
kernel."""

import math

import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "train_clips_per_s"
FWD = r"train_fwd_f32_kernel"
ALL = r"train_fwd_f32_kernel|flash_bwd_f32_kernel"


def read(trace, ctx, state):
    calls = trace.kernel_count(FWD)
    seconds = trace.seconds_matching(ALL)
    if not calls or not seconds:
        return None
    v = ctx.cfg_values
    S = 2 * math.ceil(v["INPUT.RESOLUTION"] / 32) ** 2 + v["INPUT.MAX_QUERY_LEN"]
    heads = v["MODEL.VSTG.HEADS"]
    per_call = roofline.k3_f32_bound_s(v["INPUT.TRAIN_SAMPLE_NUM"], heads, S,
                                       v["MODEL.VSTG.HIDDEN"] // heads)
    return 100.0 * calls * per_call / seconds
