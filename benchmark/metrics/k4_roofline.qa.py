"""K4 (the ViT's attention) against its bound: the traced answers' tiles x
the tower's layers at 1,025 tokens, 16 heads of 64, over K4's device time."""

import roofline

LAYER = "kernels"
UNIT = "%"
MOVES = "qa_answers_per_s"
K4 = r"flash_mha_sm90_kernel"


def read(trace, ctx, state):
    n = trace.counters.get("answers")
    seconds = trace.seconds_matching(K4)
    if not n or not seconds:
        return None
    vit = ctx.config["vit"]
    L = (vit["image_size"] // vit["patch_size"]) ** 2 + 1
    heads = vit["num_heads"]
    tiles = n * ctx.params["frames"]
    bound = vit["num_layers"] * roofline.k4_bound_s(tiles, heads, L, vit["hidden_size"] // heads)
    return 100.0 * bound / seconds
