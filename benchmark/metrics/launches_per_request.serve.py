"""Device kernels per grounding request (one V = 2 forward each) in the
traced window; forwards are counted by K2's launches, 6 per forward."""

LAYER = "two-pass forward"
UNIT = "launches"
MOVES = "ground_clips_per_s"
K2 = r"window_attn_sm90_kernel<\d+, false>"


def read(trace, ctx, state):
    forwards = trace.kernel_count(K2) / ctx.cfg_values["MODEL.VSTG.ENC_LAYERS"]
    return trace.kernel_count() / forwards if forwards else None
