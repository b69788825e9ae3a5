"""K1 in float32 (the frozen Swin tower of a training step) against the
bound of its design (the GEMM's three TF32 products at the TF32 rate, the
attention at the FFMA rate, or the bytes), over its device time. Calls are
counted by the f32 attention kernel, one per block call."""

import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "train_clips_per_s"
ATTN = r"window_attn_f32_kernel"
ALL = r"gemm_sm90_kernel<true|ln_rows_kernel<float|window_attn_f32_kernel"


def read(trace, ctx, state):
    calls = trace.kernel_count(ATTN)
    seconds = trace.seconds_matching(ALL)
    if not calls or not seconds:
        return None
    v = ctx.cfg_values
    t, res = v["INPUT.TRAIN_SAMPLE_NUM"], v["INPUT.RESOLUTION"]
    per_tower = roofline.k1_tower_bound_s(t, res, batch=1, f32=True)
    return 100.0 * calls / len(roofline.swin_blocks(t, res)) * per_tower / seconds
