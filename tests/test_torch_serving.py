"""The serving path of the port against vgqa_tpu.inference.grounding on the
frames-onward half: identical decoded uint8 frames (RGB or I420 planes) and
one carried parameter tree go through the even/odd two-pass forward and the
interpolation merge; both must give the same response dict.

Both sides serve in float32 (TPU.COMPUTE_DTYPE) on the tiny config. The
temporal span and the tube's frame ids must be equal; scores agree to atol
1e-4 and boxes to 1e-3 of the original frame size (float32 summation order
over the whole forward).
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_modules import random_params
from vgqa_tpu.config import build_default_cfg as jax_default_cfg
from vgqa_tpu.inference import grounding as jgrounding
from vgqa_tpu.models import VSTGNet as JNet
from vgqa_tpu.models import GroundingConfig as JConfig
from vgqa_tpu.utils.containers import TextBatch as JText
from vgqa_tpu.utils.containers import VideoBatch as JVideo
from vgqa_tpu_torch.config import build_default_cfg
from vgqa_tpu_torch.inference import grounding
from vgqa_tpu_torch.models.convert_jax import state_dict_from_jax
from vgqa_tpu_torch.training.evaluator import convert_outputs, dispatch_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORI = (120, 160)      # (h, w) of the "original" video
FPS = 10.0


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(JAX loaded tuple, port LoadedModel, cfg) sharing one parameter tree."""
    tiny = os.path.join(REPO, "configs", "grounding_vidstg_tiny.yaml")
    jcfg = jax_default_cfg()
    jcfg.merge_from_file(tiny)
    jcfg.TPU.COMPUTE_DTYPE = "float32"
    cfg_path = str(tmp_path_factory.mktemp("cfg") / "tiny_f32.yaml")
    with open(cfg_path, "w") as f:
        f.write(jcfg.dump())

    res, t_half = jcfg.INPUT.RESOLUTION, jcfg.INPUT.TRAIN_SAMPLE_NUM
    video = JVideo(jnp.zeros((1, t_half, res, res, 3)), jnp.ones((1, res, res), bool),
                   jnp.ones((1, t_half), bool))
    text = JText(jnp.ones((1, jcfg.INPUT.MAX_QUERY_LEN), jnp.int32),
                 jnp.ones((1, jcfg.INPUT.MAX_QUERY_LEN), bool))
    params = random_params(JNet(JConfig.from_cfg(jcfg)), video, text, seed=5)

    class Preset(JNet):
        """The JAX model with ``init`` returning the numpy tree (nothing to
        compile for the initialization)."""

        def init(self, *args, **kwargs):
            return params

    orig = jgrounding.VSTGNet
    jgrounding.VSTGNet = Preset
    try:
        jloaded = jgrounding._load_model(cfg_path, "")
    finally:
        jgrounding.VSTGNet = orig
        jgrounding._load_model.cache_clear()

    cfg = build_default_cfg()
    cfg.merge_from_file(cfg_path)
    tloaded = grounding.load_model(cfg, device="cpu", state_dict=state_dict_from_jax(params))
    return jloaded, tloaded, cfg


def _jax_response(jloaded, job):
    fwd, params, video, text, infos, gt_act, canvas = jgrounding._group_inputs(jloaded, [job])
    b1, a1, t1, _ = jgrounding.single_forward(fwd, params, video, text, infos, gt_act,
                                              canvas=canvas)
    return jgrounding._merge_halves(b1, a1, t1, 0, FPS)


def _assert_same_response(out_t, out_j):
    assert out_t["temporal"] == out_j["temporal"]
    assert [e["frame"] for e in out_t["tube"]] == [e["frame"] for e in out_j["tube"]]
    np.testing.assert_allclose([e["score"] for e in out_t["tube"]],
                               [e["score"] for e in out_j["tube"]], atol=1e-4)
    np.testing.assert_allclose([e["bbox"] for e in out_t["tube"]],
                               [e["bbox"] for e in out_j["tube"]], atol=1e-3 * max(ORI))


def test_rgb_frames_response_matches_jax(served):
    jloaded, tloaded, cfg = served
    res, t2 = cfg.INPUT.RESOLUTION, 2 * cfg.INPUT.TRAIN_SAMPLE_NUM
    frames = np.random.RandomState(1).randint(0, 256, (t2, res, res, 3), np.uint8)
    frame_ids = np.arange(0, 3 * t2, 3)
    query = "a green square moves right"
    job = {"frames": jnp.asarray(frames), "frame_ids": frame_ids, "yuv": False,
           "full_range": 0.0, "fps": FPS, "ori_size": ORI, "query": query}
    out_j = _jax_response(jloaded, job)
    out_t = grounding.predict_many(
        [{"frames": frames, "frame_ids": frame_ids, "fps": FPS, "ori_size": ORI,
          "query": query}], loaded=tloaded)[0]
    _assert_same_response(out_t, out_j)
    assert len(out_t["tube"]) == frame_ids[-1] - frame_ids[0] + 1


@pytest.mark.parametrize("full_range", [0.0, 1.0])
def test_i420_frames_response_matches_jax(served, full_range):
    import torch

    jloaded, tloaded, cfg = served
    res, t2 = cfg.INPUT.RESOLUTION, 2 * cfg.INPUT.TRAIN_SAMPLE_NUM
    planes = np.random.RandomState(2).randint(0, 256, (t2, res * res * 3 // 2), np.uint8)
    job = {"frame_ids": np.arange(t2), "yuv": True, "full_range": full_range,
           "fps": FPS, "ori_size": ORI, "query": "a red circle"}
    out_j = _jax_response(jloaded, {**job, "frames": jnp.asarray(planes)})
    fwd, video, text, infos, gt_act, canvas = grounding._group_inputs(
        tloaded, [{**job, "frames": torch.from_numpy(planes)}])
    packed, span = dispatch_forward(fwd, video, text, infos, canvas=canvas)
    b1, a1, t1, _ = convert_outputs(packed, span, infos, gt_act)
    _assert_same_response(grounding._merge_halves(b1, a1, t1, 0, FPS), out_j)
