"""Guards of the port's boundaries: no module of ``vgqa_tpu_torch`` (nor
``chip_smoke.py``, ``chip_k6.py`` or ``chip_k4.py``) imports the JAX stack or anything of
``vgqa_tpu``; the entry points run on the card unless the caller asks for the CPU; and the
port's copy of the tokenizer gives vgqa_tpu's ids."""

import ast
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("vgqa_tpu", "jax", "jaxlib", "flax", "optax")


def _port_sources():
    root = os.path.join(REPO, "vgqa_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "chip_k6.py")
    yield os.path.join(REPO, "chip_k4.py")


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_nothing_of_jax_or_vgqa_tpu():
    bad = []
    n_files = 0
    for path in _port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        n_files += 1
        for name in _imported(tree):
            if name.split(".")[0] in FORBIDDEN:
                bad.append(f"{os.path.relpath(path, REPO)}: import {name}")
    assert n_files > 30
    assert not bad, bad


def _tiny_cfg():
    from vgqa_tpu_torch.config import build_default_cfg

    cfg = build_default_cfg()
    cfg.MODEL.VISION_BACKBONE.NAME = "resnet_test"
    cfg.MODEL.VIDEO_SWIN.MODEL_NAME = "video_swin_test"
    cfg.MODEL.VIDEO_SWIN.FEATURE_DIM = 64
    cfg.MODEL.TEXT_MODEL.NUM_LAYERS = 2
    cfg.MODEL.VSTG.HIDDEN = 32
    cfg.MODEL.VSTG.HEADS = 4
    return cfg


def test_entry_points_need_a_card_unless_asked_for_cpu(monkeypatch):
    from vgqa_tpu_torch.inference.grounding import load_model
    from vgqa_tpu_torch.training.trainer import Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_cfg()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        load_model(cfg)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Trainer(cfg)
    assert load_model(cfg, device="cpu").device.type == "cpu"
    assert Trainer(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("max_len", [6, 26])
def test_tokenizer_copy_matches_vgqa_tpu(max_len):
    from vgqa_tpu.data import tokenizer as jtok
    from vgqa_tpu_torch.data import tokenizer as ttok

    queries = ["the man in red walks to the car", "What is the dog doing?",
               "a child's 2nd ball, rolling_away!", ""]
    for vocab in (50265, 128):
        ids_t, mask_t = ttok.batch_encode(ttok.build_tokenizer("", vocab), queries, max_len)
        ids_j, mask_j = jtok.batch_encode(jtok.build_tokenizer("", vocab), queries, max_len)
        np.testing.assert_array_equal(ids_t, ids_j)
        np.testing.assert_array_equal(mask_t, mask_j)
