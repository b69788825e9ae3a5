"""Every traffic generator gives the same inputs for the same seed and
other inputs for another seed."""

import json
import os

import numpy as np
import pytest
import torch

from harness import load_module
from vstg_common import declarative_queries

SEEDS = (2 ** 31 + 5, 2 ** 31 + 6)


def test_grounding_queries():
    a, b = (declarative_queries(s, 64) for s in SEEDS)
    assert a == declarative_queries(SEEDS[0], 64) and a != b
    assert all(8 <= len(q.split()) <= 20 for q in a + b)


def test_grounding_frames():
    drv = load_module("traffic", "grounding_closed_loop")
    a, b = (drv._frames(s, 2, 4, 16, torch.device("cpu")) for s in SEEDS)
    again = drv._frames(SEEDS[0], 2, 4, 16, torch.device("cpu"))
    assert all(np.array_equal(x, y) for x, y in zip(a, again))
    assert not np.array_equal(a[0], b[0]) and a[0].dtype == np.uint8


def test_qa_questions():
    drv = load_module("traffic", "qa_batches")
    a, b = (drv.questions(s, 64, 15, 40) for s in SEEDS)
    assert a == drv.questions(SEEDS[0], 64, 15, 40) and a != b
    assert all(15 <= len(q.split()) <= 40 for q in a + b)


def test_training_set(tmp_path):
    from vgqa_tpu_torch.data import synthetic

    def make(seed, sub):
        d = tmp_path / sub
        synthetic.make_synthetic_dataset(str(d), num_videos=2, frames_per_video=24,
                                         size=(96, 64), splits=("train",), seed=seed,
                                         write_videos=False)
        ann = json.load(open(os.path.join(d, "sent_annos", "train_annotations.json")))
        frames = synthetic.frame_reader(24, (96, 64), seed)(
            str(d / "videos" / "train_vid000.mp4"), list(range(24)))
        return ann, frames

    (a_ann, a_fr), (b_ann, b_fr), (c_ann, c_fr) = (make(SEEDS[0], "a"), make(SEEDS[1], "b"),
                                                    make(SEEDS[0], "c"))
    assert a_ann == c_ann and np.array_equal(a_fr, c_fr)
    assert not np.array_equal(a_fr, b_fr)


@pytest.mark.parametrize("draw", ["normal", "uniform"])
def test_seeded_weights(draw):
    from weights import seeded_weights

    with torch.device("meta"):
        m = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.LayerNorm(16))
    if draw == "uniform":
        from reference.vstg.layers import LearnedPosition2D
        with torch.device("meta"):
            m = LearnedPosition2D(4, 5)
    a, b, c = (seeded_weights(m, s, "cpu") for s in (SEEDS[0], SEEDS[1], SEEDS[0]))
    assert all(torch.equal(a[k], c[k]) for k in a)
    assert any(not torch.equal(a[k], b[k]) for k in a)
