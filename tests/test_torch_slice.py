"""The grounding slice as a whole: the tiny VSTGNet forward of the port
against vgqa_tpu with one random parameter tree, with the kernel routes on
(JAX runs its Pallas kernels in interpret mode, the port runs the kernels'
plain versions on the CPU) and off; predict() on an mp4; and the port
serving frames with jax, flax, optax, yaml and cv2 unimportable.

Tolerance: atol 1e-3 on pred_boxes, pred_sted and att_sequences (float32;
summation-order differences accumulate over ~40 layers). select_mask and
the postprocessed spans must be equal, and the test first asserts that no
score lies within 1e-4 of a decision boundary (theta, 0.5, an argmax tie),
so an equal result is not luck.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modules import random_params, to_port
from vgqa_tpu.models import GroundingConfig as JConfig
from vgqa_tpu.models import VSTGNet as JNet
from vgqa_tpu.models.postprocess import postprocess as jpostprocess
from vgqa_tpu.utils.containers import TextBatch as JText
from vgqa_tpu.utils.containers import VideoBatch as JVideo
from vgqa_tpu_torch.models import GroundingConfig as TConfig
from vgqa_tpu_torch.models import VSTGNet as TNet
from vgqa_tpu_torch.models.postprocess import postprocess as tpostprocess
from vgqa_tpu_torch.utils.containers import TextBatch, VideoBatch

ATOL = 1e-3
MARGIN = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs():
    rng = np.random.RandomState(0)
    V, T, H, W, L = 2, 6, 64, 64, 7
    frames = rng.randn(V, T, H, W, 3).astype(np.float32)
    pixel_mask = np.ones((V, H, W), bool)
    pixel_mask[1, :, 40:] = False
    time_mask = np.ones((V, T), bool)
    time_mask[1, 5] = False
    ids = rng.randint(4, 128, (V, L)).astype(np.int32)
    text_mask = np.ones((V, L), bool)
    text_mask[1, 5:] = False
    return frames, pixel_mask, time_mask, ids, text_mask


@pytest.fixture(scope="module")
def jax_params():
    frames, pm, tm, ids, tmask = _inputs()
    video = JVideo(jnp.asarray(frames), jnp.asarray(pm), jnp.asarray(tm))
    text = JText(jnp.asarray(ids), jnp.asarray(tmask))
    return random_params(JNet(JConfig.tiny_test()), video, text, seed=3)


def _first_pass_actioness(model, video, text):
    """sigmoid of the actioness head on the first decode: the scores the
    second-pass selection thresholds at 0.5."""
    seen = []
    handle = model.action_embed.register_forward_hook(lambda m, i, o: seen.append(o))
    try:
        with torch.no_grad():
            out = model(video, text)
    finally:
        handle.remove()
    return out, torch.sigmoid(seen[0][..., 0]).numpy()


@pytest.mark.parametrize("kernels", [False, True])
def test_forward_matches_jax(jax_params, kernels, monkeypatch):
    monkeypatch.setenv("VGQA_PALLAS_INTERPRET", "1" if kernels else "0")
    frames, pm, tm, ids, tmask = _inputs()
    jnet = JNet(dataclasses.replace(JConfig.tiny_test(), use_pallas_attention=kernels))
    video_j = JVideo(jnp.asarray(frames), jnp.asarray(pm), jnp.asarray(tm))
    text_j = JText(jnp.asarray(ids), jnp.asarray(tmask))
    out_j = jax.jit(lambda p: jnet.apply(p, video_j, text_j))(jax_params)

    tnet, _ = to_port(TNet(dataclasses.replace(TConfig.tiny_test(),
                                               use_pallas_attention=kernels)), jax_params)
    video = VideoBatch(torch.from_numpy(frames), torch.from_numpy(pm), torch.from_numpy(tm))
    text = TextBatch(torch.from_numpy(ids).long(), torch.from_numpy(tmask))
    out_t, act = _first_pass_actioness(tnet, video, text)

    # no decision within MARGIN of its boundary
    att = out_t["att_sequences"].numpy()
    assert np.abs(att - tnet.cfg.theta)[tm].min() > MARGIN
    assert np.abs(act - 0.5)[tm].min() > MARGIN

    for k in ("pred_boxes", "pred_sted", "att_sequences"):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), atol=ATOL)
    np.testing.assert_array_equal(out_t["select_mask"].numpy(),
                                  np.asarray(out_j["select_mask"]))

    sizes = np.array([[120, 160], [90, 90]], np.float32)
    spans_t = tpostprocess(out_t["pred_boxes"], out_t["pred_sted"],
                           torch.from_numpy(sizes), torch.from_numpy(tm))
    spans_j = jpostprocess(out_j["pred_boxes"], out_j["pred_sted"], jnp.asarray(sizes),
                           jnp.asarray(tm))
    # the best (start, end) pair beats the runner-up by more than MARGIN
    sted = torch.where(torch.from_numpy(tm)[..., None], out_t["pred_sted"], -1e32)
    lp = torch.log_softmax(sted, dim=1)
    T = tm.shape[1]
    pair = lp[:, :, None, 0] + lp[:, None, :, 1]
    ok = torch.triu(torch.ones(T, T, dtype=torch.bool), 1) & torch.from_numpy(
        tm[:, :, None] & tm[:, None, :])
    top2 = torch.where(ok, pair, -1e32).reshape(2, -1).topk(2).values
    assert (top2[:, 0] - top2[:, 1]).min() > MARGIN
    for a, b in zip(spans_t[1:], spans_j[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _tiny_cfg():
    from vgqa_tpu_torch.config import build_default_cfg

    cfg = build_default_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs", "grounding_vidstg_tiny.yaml"))
    return cfg


def test_predict_mp4_returns_schema(tmp_path):
    from vgqa_tpu.data.synthetic import write_synthetic_video
    from vgqa_tpu_torch.inference import grounding

    video = str(tmp_path / "clip.mp4")
    write_synthetic_video(video, 21, (96, 72), seed=1)   # odd count, short video
    cfg_path = str(tmp_path / "tiny.yaml")
    with open(cfg_path, "w") as f:
        f.write(_tiny_cfg().dump())
    result = grounding.predict(video, "a green square moves right", cfg_path,
                               ckpt_path="", device_str="cpu")
    assert set(result) == {"temporal", "tube"}
    assert 0 <= result["temporal"]["start"] <= result["temporal"]["end"]
    frames = [e["frame"] for e in result["tube"]]
    assert frames == list(range(min(frames), max(frames) + 1))
    for e in result["tube"]:
        assert set(e) == {"frame", "bbox", "score"}
        x0, y0, x1, y1 = e["bbox"]
        assert 0 <= x0 <= x1 <= 96 and 0 <= y0 <= y1 <= 72
    bad = grounding.predict_many([{"video_path": str(tmp_path / "nope.mp4"), "query": "x"}],
                                 loaded=grounding._load_model(cfg_path, "", "cpu"))
    assert isinstance(bad[0], FileNotFoundError)


_NO_JAX = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "yaml", "cv2", "vgqa_tpu"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is not installed on the card machine")
            return None

    sys.meta_path.insert(0, Refuse())
    import numpy as np
    from vgqa_tpu_torch.config import build_default_cfg
    from vgqa_tpu_torch.inference.grounding import load_model, predict_many

    cfg = build_default_cfg()
    cfg.INPUT.RESOLUTION = 64
    cfg.INPUT.TRAIN_SAMPLE_NUM = 4
    cfg.MODEL.VISION_BACKBONE.NAME = "resnet_test"
    cfg.MODEL.VIDEO_SWIN.MODEL_NAME = "video_swin_test"
    cfg.MODEL.VIDEO_SWIN.FEATURE_DIM = 64
    cfg.MODEL.TEXT_MODEL.NUM_LAYERS = 2
    cfg.MODEL.VSTG.HIDDEN = 32
    cfg.MODEL.VSTG.HEADS = 4
    cfg.MODEL.VSTG.ENC_LAYERS = 1
    cfg.MODEL.VSTG.DEC_LAYERS = 1
    cfg.MODEL.VSTG.FFN_DIM = 64
    cfg.TPU.COMPUTE_DTYPE = "float32"
    loaded = load_model(cfg, device="cpu")
    frames = np.random.RandomState(0).randint(0, 255, (8, 64, 64, 3), np.uint8)
    out = predict_many([{"frames": frames, "fps": 8.0, "ori_size": (48, 80),
                         "query": "a red ball"}], loaded=loaded)[0]
    assert len(out["tube"]) == 8, out
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    print("SERVED", out["temporal"])
""")


def test_port_serves_without_jax_yaml_cv2():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "SERVED" in proc.stdout
