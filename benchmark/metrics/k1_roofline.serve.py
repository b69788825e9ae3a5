"""K1 (the Swin block chain) against its bound, bf16 at the served shapes:
the bound of the traced window's K1 calls over their device time. Calls are
counted by K1's attention kernel (one per block call); the kernels are the
GEMM, the attention's terms form and the LayerNorm rows."""

import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "ground_clips_per_s"
ATTN = r"window_attn_sm90_kernel<\d+, true>"
ALL = r"gemm_sm90_kernel|ln_rows_kernel|window_attn_sm90_kernel<\d+, true>"


def read(trace, ctx, state):
    calls = trace.kernel_count(ATTN)
    seconds = trace.seconds_matching(ALL)
    if not calls or not seconds:
        return None
    v = ctx.cfg_values
    blocks = roofline.swin_blocks(v["INPUT.TRAIN_SAMPLE_NUM"], v["INPUT.RESOLUTION"])
    per_forward = roofline.k1_tower_bound_s(v["INPUT.TRAIN_SAMPLE_NUM"],
                                            v["INPUT.RESOLUTION"], batch=2)
    return 100.0 * calls / len(blocks) * per_forward / seconds
