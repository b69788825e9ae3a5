"""The served forward's share of the card's dense bf16 peak: the FLOPs of
one request (the reference's V = 2 forward, counted on the ``meta`` device
by ``flops.py``) times the forwards in the traced window (K2 launches / 6),
over the window's seconds, over 989 TFLOP/s."""

import flops
import roofline

LAYER = "model"
UNIT = "%"
MOVES = "ground_clips_per_s"
K2 = r"window_attn_sm90_kernel<\d+, false>"


def read(trace, ctx, state):
    forwards = trace.kernel_count(K2) / ctx.cfg_values["MODEL.VSTG.ENC_LAYERS"]
    if not forwards:
        return None
    per_request = flops.grounding_request_flops(ctx.cfg_values)
    return 100.0 * per_request * forwards / trace.window_s / roofline.PEAK_BF16
