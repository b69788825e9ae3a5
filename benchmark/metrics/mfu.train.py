"""The training step's share of the card's float32 ceiling: the FLOPs of
one step (the reference's forward, loss and backward over a batch of the
window's shapes, counted on the ``meta`` device by ``flops.py``) times the
steps of the traced window, over its seconds, over 164.9 TFLOP/s (the
dense TF32 rate / 3, since the port computes float32 products as three
TF32 ones)."""

import flops
import roofline

LAYER = "model"
UNIT = "%"
MOVES = "train_clips_per_s"


def read(trace, ctx, state):
    steps, batch = trace.counters.get("steps"), trace.counters.get("batch")
    if not steps or batch is None:
        return None
    per_step = flops.grounding_step_flops(ctx.cfg_values, batch)
    return 100.0 * per_step * steps / trace.window_s / (roofline.PEAK_TF32 / 3)
