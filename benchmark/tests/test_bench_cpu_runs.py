"""Whole runs of each cell on the CPU at tiny sizes, past the look for a
card: the program (its plain kernel versions) agrees with the reference and
``correct`` holds; with the timed path broken underneath, ``correct`` comes
out false, once for each fault the cell can have."""

import pytest

import run
from faults import (qa_half_batch, qa_last_slot_altered, qa_token_altered,
                    serve_answer_altered, serve_box_first_layer, serve_half_batch,
                    train_state_unchanged)

SEED = 2 ** 31 + 77
GROUNDING = {
    "INPUT.RESOLUTION": 64, "INPUT.TRAIN_SAMPLE_NUM": 4,
    "MODEL.VISION_BACKBONE.NAME": "resnet_test", "MODEL.VIDEO_SWIN.MODEL_NAME": "video_swin_test",
    "MODEL.VIDEO_SWIN.FEATURE_DIM": 64, "MODEL.TEXT_MODEL.NUM_LAYERS": 2,
    "MODEL.VSTG.HIDDEN": 32, "MODEL.VSTG.HEADS": 4, "MODEL.VSTG.ENC_LAYERS": 2,
    "MODEL.VSTG.DEC_LAYERS": 2, "MODEL.VSTG.FFN_DIM": 64}
SERVE = {"cfg": dict(GROUNDING, **{"TPU.COMPUTE_DTYPE": "float32"}),
         "params": {"videos": 3, "check_requests": 1000, "warmup_requests": 2}}
TRAIN = {"cfg": dict(GROUNDING, **{"DATALOADER.NUM_WORKERS": 2}),
         "params": {"videos": 2, "frames_per_video": 24, "video_size": [96, 64]}}
# LLMConfig.tiny() and ViTConfig.tiny(), the port's "__tiny__" QA model
QA = {"llm": {"vocab_size": 256, "hidden_size": 64, "num_layers": 2, "num_heads": 4,
              "num_kv_heads": 2, "intermediate_size": 128, "rope_theta": 10000.0},
      "vit": {"image_size": 32, "patch_size": 8, "hidden_size": 32, "num_layers": 2,
              "num_heads": 4, "intermediate_size": 64, "llm_hidden_size": 64},
      "params": {"frames": 4, "videos": 2, "check_requests": 1000, "new_tokens": 6}}


def _run(cell, overrides, fault=None, seconds=2.0):
    result, rc = run.run(cell, SEED, seconds, False, device="cpu", overrides=overrides,
                         fault=fault)
    assert rc == 0 and result["checks"]
    return result


@pytest.mark.parametrize("cell,overrides", [
    ("vstg420_serve_c4", SERVE), ("vstg420_train_f32", TRAIN), ("ivc8b_qa_b4", QA)])
def test_sound_run_is_correct(cell, overrides):
    result = _run(cell, overrides)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


@pytest.mark.parametrize("cell,overrides,fault,caught_by", [
    ("vstg420_serve_c4", SERVE, serve_answer_altered, "span_gap_q75"),
    ("vstg420_serve_c4", SERVE, serve_half_batch, None),
    ("vstg420_serve_c4", SERVE, serve_box_first_layer, "box_rms_median"),
    ("vstg420_train_f32", TRAIN, train_state_unchanged, None),
    ("ivc8b_qa_b4", QA, qa_token_altered, None),
    ("ivc8b_qa_b4", QA, qa_half_batch, None),
    ("ivc8b_qa_b4", QA, qa_last_slot_altered, None),
])
def test_broken_path_is_not_correct(cell, overrides, fault, caught_by):
    result = _run(cell, overrides, fault)
    assert not result["correct"], result["checks"]
    if caught_by:
        c = result["checks"][caught_by]
        assert c["value"] > c["limit"], result["checks"]
