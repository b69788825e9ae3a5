"""Module parity: each module of vgqa_tpu_torch against its vgqa_tpu
counterpart, with one random parameter tree (numpy, fixed seed) carried into
the port by ``state_dict_from_jax``, and the same numpy inputs.

Everything runs in float32. Tolerances: atol 1e-5 for the parameter-free
encodings and the attention core (same f32 ops, other summation order);
1e-4 for modules with a few matmul layers; 1e-3 for the deep stacks
(ResNet, the Swin backbone against the TPU kernel path, the head chain),
where f32 summation-order differences accumulate across layers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgqa_tpu.models import bert_blocks as jbb
from vgqa_tpu.models import decoder as jdec
from vgqa_tpu.models import encoder as jenc
from vgqa_tpu.models import layers as jlayers
from vgqa_tpu.models.postprocess import postprocess as jpostprocess
from vgqa_tpu.models import resnet as jres
from vgqa_tpu.models import roberta as jrob
from vgqa_tpu.models import video_swin as jvs
from vgqa_tpu.models import vstgnet as jvst
from vgqa_tpu.ops import attention as jatt
from vgqa_tpu.ops import position_encoding as jpe
from vgqa_tpu_torch.models import decoder as tdec
from vgqa_tpu_torch.models import encoder as tenc
from vgqa_tpu_torch.models import layers as tlayers
from vgqa_tpu_torch.models.postprocess import postprocess as tpostprocess
from vgqa_tpu_torch.models import resnet as tres
from vgqa_tpu_torch.models import roberta as trob
from vgqa_tpu_torch.models import video_swin as tvs
from vgqa_tpu_torch.models import vstgnet as tvst
from vgqa_tpu_torch.models.convert_jax import state_dict_from_jax
from vgqa_tpu_torch.ops import attention as tatt
from vgqa_tpu_torch.ops import position_encoding as tpe

EXACT = 1e-5
SHALLOW = 1e-4
DEEP = 1e-3


def random_params(module, *args, seed=0, method=None, **kwargs):
    """A parameter tree with the structure ``module.init`` would give, filled
    from numpy: fan-in scaled kernels, norms near 1, small biases. Only
    shapes are traced (``jax.eval_shape``), so nothing compiles."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, method=method, **kwargs))
    rng = np.random.RandomState(seed)

    def fill(path, s):
        name = path[-1].key
        if name in ("kernel", "patch_embed_kernel"):
            std = float(np.prod(s.shape[:-1])) ** -0.5
        elif name == "scale":
            return (1.0 + 0.1 * rng.randn(*s.shape)).astype(np.float32)
        elif name == "embedding":
            std = 0.5
        elif name == "relative_position_bias_table":
            std = 0.2
        else:
            std = 0.1
        return (std * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def japply(module, params, *args, method=None):
    """``module.apply`` under ``jax.jit`` (far faster on the CPU than
    op-by-op dispatch for these graphs)."""
    return jax.jit(lambda p, *a: module.apply(p, *a, method=method))(params, *args)


def to_port(tmodule, params, strict=True):
    """Load a JAX tree into a port module (eval mode)."""
    sd = state_dict_from_jax(params, tmodule if strict else None)
    missing, unexpected = tmodule.load_state_dict(sd, strict=strict)
    assert not unexpected
    return tmodule.eval(), missing


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(t_out, j_out, atol):
    np.testing.assert_allclose(t_out.detach().float().numpy(),
                               np.asarray(j_out, np.float32), atol=atol)


def test_default_config_matches_jax():
    from vgqa_tpu.config import build_default_cfg as jcfg
    from vgqa_tpu_torch.config import build_default_cfg as tcfg

    assert tcfg().to_dict() == jcfg().to_dict()


def test_position_encodings():
    rng = np.random.RandomState(0)
    mask = np.ones((2, 5, 7), bool)
    mask[1, :, 5:] = False
    mask[1, 4:] = False
    _close(tpe.sine_position_2d(_t(mask), 16), jpe.sine_position_2d(jnp.asarray(mask), 16), EXACT)
    _close(tpe.sine_position_hw_2d(_t(mask), 16),
           jpe.sine_position_hw_2d(jnp.asarray(mask), 16), EXACT)
    _close(tpe.sine_position_1d(9, 32), jpe.sine_position_1d(9, 32), EXACT)
    for d in (2, 4):
        boxes = rng.rand(3, 5, d).astype(np.float32)
        _close(tpe.box_sine_embedding(_t(boxes)), jpe.box_sine_embedding(jnp.asarray(boxes)),
               EXACT)


@pytest.mark.parametrize("mask_kind", ["none", "keys", "pairs", "bias_probs"])
def test_dot_product_attention(mask_kind):
    rng = np.random.RandomState(1)
    q = rng.randn(2, 3, 5, 16).astype(np.float32)
    k = rng.randn(2, 3, 7, 16).astype(np.float32)
    v = rng.randn(2, 3, 7, 8).astype(np.float32)
    kw_t, kw_j = {}, {}
    if mask_kind == "keys":
        m = rng.rand(2, 3, 7) > 0.3
        m[..., 0] = True
        kw_t["key_mask"], kw_j["key_mask"] = _t(m), jnp.asarray(m)
    if mask_kind == "pairs":
        m = rng.rand(2, 3, 5, 7) > 0.3
        m[..., 0] = True
        kw_t["key_mask"], kw_j["key_mask"] = _t(m), jnp.asarray(m)
    if mask_kind == "bias_probs":
        b = rng.randn(4, 5, 7).astype(np.float32)
        kw_t.update(attn_bias=_t(b), return_probs=True, scale=0.3)
        kw_j.update(attn_bias=jnp.asarray(b), return_probs=True, scale=0.3)
    out_t = tatt.dot_product_attention(_t(q), _t(k), _t(v), 4, **kw_t)
    out_j = jatt.dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4,
                                       **kw_j)
    if mask_kind == "bias_probs":
        _close(out_t[1], out_j[1], EXACT)
        out_t, out_j = out_t[0], out_j[0]
    _close(out_t, out_j, EXACT)


@pytest.mark.parametrize("use_flash", [False, True])
def test_multi_head_attention(use_flash, monkeypatch):
    monkeypatch.setenv("VGQA_PALLAS_INTERPRET", "1")
    rng = np.random.RandomState(2)
    x = rng.randn(2, 3, 10, 64).astype(np.float32)
    mask = rng.rand(2, 3, 10) > 0.3
    mask[..., 0] = True
    jm = jlayers.MultiHeadAttention(num_heads=2, use_flash=use_flash)
    xj, mj = jnp.asarray(x), jnp.asarray(mask)
    params = random_params(jm, xj, xj, xj, key_mask=mj)
    out_j = jax.jit(lambda p: jm.apply(p, xj, xj, xj, key_mask=mj))(params)
    tm, _ = to_port(tlayers.MultiHeadAttention(64, 2, use_flash=use_flash), params)
    with torch.no_grad():
        out_t = tm(_t(x), _t(x), _t(x), key_mask=_t(mask))
    _close(out_t, out_j, SHALLOW)


@pytest.mark.parametrize("name", ["resnet_test", "resnet_test-gn"])
def test_resnet(name):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 64, 48, 3).astype(np.float32)
    jm = jres.build_resnet(name)
    params = random_params(jm, jnp.asarray(x))
    out_j = japply(jm, params, jnp.asarray(x))
    tm, _ = to_port(tres.build_resnet(name), params)
    with torch.no_grad():
        out_t = tm(_t(x))
    assert out_t.shape == out_j.shape
    _close(out_t, out_j, DEEP)
    pm = np.zeros((2, 64, 48), bool)
    pm[0, :50, :40] = True
    np.testing.assert_array_equal(tres.downsample_mask(_t(pm), (2, 3)).numpy(),
                                  np.asarray(jres.downsample_mask(jnp.asarray(pm), (2, 3))))


@pytest.mark.parametrize("frames_shape", [(1, 3, 20, 12, 3), (2, 4, 32, 16, 3)])
def test_swin_backbone(frames_shape):
    """Padded (20x12) and row-batched (32x16) geometries; the port against
    the flax module path and against the Pallas canvas path."""
    cfg_j = jvs.VideoSwinConfig.tiny_test()
    rng = np.random.RandomState(4)
    x = rng.randn(*frames_shape).astype(np.float32)
    jm = jvs.VideoSwinBackbone(cfg_j)
    params = random_params(jm, jnp.asarray(x))
    out_module = japply(jm, params, jnp.asarray(x))
    out_fused = jax.jit(lambda p, a: jvs.fused_backbone_apply(p, a, cfg_j, interpret=True))(
        params["params"], jnp.asarray(x))
    tm, _ = to_port(tvs.VideoSwinBackbone(tvs.VideoSwinConfig.tiny_test()), params)
    with torch.no_grad():
        out_t = tm(_t(x))
    assert set(out_t) == set(out_module)
    for k in out_module:
        _close(out_t[k], out_module[k], DEEP)
        _close(out_t[k], out_fused[k], DEEP)


def test_text_encoder():
    cfg = jrob.RobertaConfig.tiny()
    rng = np.random.RandomState(5)
    ids = rng.randint(0, 200, (2, 9)).astype(np.int32)   # ids >= 128 are clamped
    mask = np.ones((2, 9), bool)
    mask[1, 6:] = False
    jm = jrob.TextEncoder(cfg, out_dim=32)
    params = random_params(jm, jnp.asarray(ids), jnp.asarray(mask))
    tok_j, cls_j = japply(jm, params, jnp.asarray(ids), jnp.asarray(mask))
    tm, _ = to_port(trob.TextEncoder(trob.RobertaConfig.tiny(), out_dim=32), params)
    with torch.no_grad():
        tok_t, cls_t = tm(_t(ids).long(), _t(mask))
    _close(tok_t, tok_j, SHALLOW)
    _close(cls_t, cls_j, SHALLOW)


def _encoder_inputs(rng, V=2, T=3, hw=6, L=5, d=32):
    vis = rng.randn(V, T, hw, d).astype(np.float32)
    swin = rng.randn(V, T, hw, d).astype(np.float32)
    text = rng.randn(V, L, d).astype(np.float32)
    pos = rng.randn(V, hw, d).astype(np.float32)
    vis_mask = rng.rand(V, hw) > 0.3
    text_mask = np.ones((V, L), bool)
    text_mask[1, 3:] = False
    time_mask = np.ones((V, T), bool)
    time_mask[1, -1] = False
    return vis, swin, text, pos, vis_mask, text_mask, time_mask


@pytest.mark.parametrize("use_flash", [False, True])
def test_cross_modal_encoder(use_flash, monkeypatch):
    monkeypatch.setenv("VGQA_PALLAS_INTERPRET", "1")
    inputs = _encoder_inputs(np.random.RandomState(6))
    jm = jenc.CrossModalEncoder(2, 4, 64, use_flash=use_flash)
    jin = [jnp.asarray(a) for a in inputs]
    params = random_params(jm, *jin)
    out_j = japply(jm, params, *jin)
    tm, _ = to_port(tenc.CrossModalEncoder(32, 2, 4, 64, use_flash=use_flash), params)
    with torch.no_grad():
        out_t = tm(*[_t(a) for a in inputs])
    for k in ("encoded", "frames_cls", "videos_cls", "vis_mask"):
        _close(out_t[k], out_j[k], SHALLOW)


def test_classifier_heads():
    rng = np.random.RandomState(7)
    feats = rng.randn(2, 3, 6, 32).astype(np.float32)
    text = rng.randn(2, 5, 32).astype(np.float32)
    text_mask = np.ones((2, 5), bool)
    text_mask[0, 4:] = False
    frame_mask = np.array([[1, 0, 1], [1, 1, 1]], bool)

    jm = jenc.TemporalSampling()
    jin = (jnp.asarray(feats), jnp.asarray(text), jnp.asarray(text_mask))
    params = random_params(jm, *jin)
    tm, _ = to_port(tenc.TemporalSampling(32), params)
    with torch.no_grad():
        _close(tm(_t(feats), _t(text), _t(text_mask)), japply(jm, params, *jin), SHALLOW)

    jm = jenc.SpatialActivation(5)
    jin = (jnp.asarray(feats), jnp.asarray(text[:, :1]), jnp.asarray(frame_mask))
    params = random_params(jm, *jin, seed=1)
    logits_j, att_j = japply(jm, params, *jin)
    tm, _ = to_port(tenc.SpatialActivation(32, 5), params)
    with torch.no_grad():
        logits_t, att_t = tm(_t(feats), _t(text[:, :1]), _t(frame_mask))
    _close(logits_t, logits_j, SHALLOW)
    _close(att_t, att_j, SHALLOW)

    jm = jbb.PredictionHead(7)
    params = random_params(jm, jnp.asarray(text), seed=2)
    from vgqa_tpu_torch.models.bert_blocks import PredictionHead

    tm, _ = to_port(PredictionHead(32, 7), params)
    with torch.no_grad():
        _close(tm(_t(text)), jm.apply(params, jnp.asarray(text)), SHALLOW)


@pytest.mark.parametrize("learned_time", [False, True])
def test_query_decoder(learned_time):
    rng = np.random.RandomState(8)
    vis, swin, text, pos, vis_mask, text_mask, time_mask = _encoder_inputs(rng)
    V, T, hw, d = vis.shape
    L = text.shape[1]
    encoded = rng.randn(V, T, 2 * hw + L, d).astype(np.float32)
    frames_cls = rng.randn(V, T, d).astype(np.float32)
    videos_cls = rng.randn(V, d).astype(np.float32)
    isq, itq = rng.randn(V, d).astype(np.float32), rng.randn(V, d).astype(np.float32)

    def enc(f):
        return {"encoded": f(encoded), "frames_cls": f(frames_cls),
                "videos_cls": f(videos_cls), "vis_pos": f(pos), "vis_mask": f(vis_mask),
                "text_mask": f(text_mask), "hw": hw, "text_len": L}

    jm = jdec.QueryDecoder(2, 4, 64, video_max_len=10, use_learned_time_embed=learned_time)
    jin = (enc(jnp.asarray), jnp.asarray(isq), jnp.asarray(itq), jnp.asarray(time_mask))
    params = random_params(jm, *jin)
    pos_j, time_j = jm.apply(params, *jin)
    tm, _ = to_port(tdec.QueryDecoder(d, 2, 4, 64, 10, learned_time), params)
    with torch.no_grad():
        pos_t, time_t = tm(enc(_t), _t(isq), _t(itq), _t(time_mask))
    _close(pos_t, pos_j, SHALLOW)
    _close(time_t, time_j, SHALLOW)


@pytest.mark.parametrize("pos_enc", ["sine", "sineHW", "learned"])
def test_forward_from_towers(pos_enc):
    import dataclasses

    rng = np.random.RandomState(9)
    V, T, h, w, L = 2, 4, 2, 3, 6
    res = rng.randn(V, T, h, w, 256).astype(np.float32)
    swin = rng.randn(V, T, h, w, 64).astype(np.float32)
    text = rng.randn(V, L, 32).astype(np.float32)
    pixel_mask = np.ones((V, 64, 96), bool)
    pixel_mask[1, :, 70:] = False
    text_mask = np.ones((V, L), bool)
    text_mask[1, 4:] = False
    time_mask = np.ones((V, T), bool)
    time_mask[0, -1] = False
    args = (res, swin, text, pixel_mask, text_mask, time_mask)
    jcfg = dataclasses.replace(jvst.GroundingConfig.tiny_test(), pos_enc=pos_enc)
    jm = jvst.VSTGNet(jcfg)
    jin = [jnp.asarray(a) for a in args]
    params = random_params(jm, *jin, method=jvst.VSTGNet.forward_from_towers)
    out_j = japply(jm, params, *jin, method=jvst.VSTGNet.forward_from_towers)
    tcfg = dataclasses.replace(tvst.GroundingConfig.tiny_test(), pos_enc=pos_enc)
    tm, missing = to_port(tvst.VSTGNet(tcfg), params, strict=False)
    # only the towers are absent from a head-chain tree
    assert {k.split(".")[0] for k in missing} == {"vis_encoder", "vid", "text_encoder"}
    with torch.no_grad():
        out_t = tm.forward_from_towers(*[_t(a) for a in args])
    for k in ("pred_boxes", "pred_sted", "pred_actioness", "att_sequences",
              "logits_r_a", "logits_r_m", "logits_f_a", "logits_f_m"):
        _close(out_t[k], out_j[k], DEEP)
    np.testing.assert_array_equal(out_t["select_mask"].numpy(),
                                  np.asarray(out_j["select_mask"]))


@pytest.mark.parametrize("letterbox", [False, True])
def test_postprocess(letterbox):
    rng = np.random.RandomState(10)
    V, T = 3, 9
    boxes = rng.rand(V, T, 4).astype(np.float32)
    sted = rng.randn(V, T, 2).astype(np.float32) * 3
    sizes = np.array([[120, 160], [90, 90], [200, 100]], np.float32)
    tm = np.ones((V, T), bool)
    tm[2, 6:] = False
    lb = (np.concatenate([rng.rand(V, 2) + 0.5, rng.rand(V, 2) * 0.1], axis=1)
          .astype(np.float32) if letterbox else None)
    out_t = tpostprocess(_t(boxes), _t(sted), _t(sizes), _t(tm),
                              None if lb is None else _t(lb))
    out_j = jpostprocess(jnp.asarray(boxes), jnp.asarray(sted), jnp.asarray(sizes),
                              jnp.asarray(tm), None if lb is None else jnp.asarray(lb))
    _close(out_t[0], out_j[0], SHALLOW)
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))


def test_state_dict_from_jax_maps_every_leaf():
    from vgqa_tpu.utils.containers import TextBatch, VideoBatch

    video = VideoBatch(jnp.zeros((1, 2, 64, 64, 3)), jnp.ones((1, 64, 64), bool),
                       jnp.ones((1, 2), bool))
    text = TextBatch(jnp.ones((1, 5), jnp.int32), jnp.ones((1, 5), bool))
    params = random_params(jvst.VSTGNet(jvst.GroundingConfig.tiny_test()), video, text)
    n_leaves = len(jax.tree_util.tree_leaves(params))
    tm = tvst.VSTGNet(tvst.GroundingConfig.tiny_test())
    sd = state_dict_from_jax(params, tm)          # raises on any mismatch
    assert len(sd) == n_leaves == len(tm.state_dict())
    tm.load_state_dict(sd, strict=True)

    bad = jax.tree_util.tree_map(lambda a: a, params)
    bad["params"]["input_proj"]["gamma"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        state_dict_from_jax(bad)
    partial = {"params": {k: v for k, v in params["params"].items() if k != "input_proj"}}
    with pytest.raises(KeyError):
        state_dict_from_jax(partial, tm)
