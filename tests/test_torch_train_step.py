"""One training step of the port against vgqa_tpu's ``make_train_step`` on
``GroundingConfig.tiny_test()``, float32, with the kernel routes on (JAX
runs its Pallas kernels in interpret mode, the port the kernels' plain
versions) and off: every loss term, the gradient of every trainable leaf,
the parameters after the step and the EMA.

Dropout is disabled on both sides, so the two runs compute the same
function: ``VSTG.DROPOUT = 0`` (K3 runs at rate 0), the tiny Swin has
drop_path_rate 0, and the fixed-rate dropouts (text tower, classifier
blocks, MLP heads, decoder queries) become the identity through a
test-local monkeypatch of ``flax.linen.Dropout.__call__`` and of the port's
``DropoutRng.dropout``.

Tolerances, float32 throughout:
- loss terms rtol 1e-4: ~40 layers of f32 arithmetic summed in another order;
- gradients atol 1e-4 * (1 + max |g| of the leaf): the same, through the
  backward of every layer;
- parameters after the step atol 5e-7 (a few f32 ulps at |p| ~ 1) plus a
  share of the group's lr: Adam's first step moves each element by
  lr * g / (|g| + eps) with g the clipped gradient, i.e. by about +-lr.
  Where the gradient is rounding noise (below 1e-6, or below 1e-3 of the
  leaf's largest; the key biases of a softmax have zero gradient in exact
  arithmetic) the sign can differ between the frameworks: 2 * lr. Elsewhere
  g / (|g| + eps) moves by at most 1/4 of the relative difference of the
  two gradients, which stays below 4e-3 for clipped gradients near eps:
  1e-3 * lr;
- EMA atol 5e-7 + 2 * (1 - decay) * lr: the EMA moves by (1 - decay) times
  the parameter step.
"""

import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modules import random_params
from vgqa_tpu.config import build_default_cfg as jcfg_default
from vgqa_tpu.models import GroundingConfig as JConfig
from vgqa_tpu.models import VSTGNet as JNet
from vgqa_tpu.models.loss import VideoSTGLoss as JLoss
from vgqa_tpu.models.loss import build_weight_dict as jweights
from vgqa_tpu.training import create_train_state
from vgqa_tpu.training import make_optimizer, make_train_step as jmake_train_step
from vgqa_tpu.utils.containers import TextBatch as JText
from vgqa_tpu.utils.containers import VideoBatch as JVideo
from vgqa_tpu.utils.containers import normalize_uint8_video as jnormalize
from vgqa_tpu_torch.config import build_default_cfg as tcfg_default
from vgqa_tpu_torch.models import GroundingConfig as TConfig
from vgqa_tpu_torch.models import VSTGNet as TNet
from vgqa_tpu_torch.models.convert_jax import state_dict_from_jax
from vgqa_tpu_torch.models.loss import VideoSTGLoss as TLoss
from vgqa_tpu_torch.models.loss import build_weight_dict as tweights
from vgqa_tpu_torch.ops.dropout import DropoutRng
from vgqa_tpu_torch.training.optimizer import GroupedAdamW
from vgqa_tpu_torch.training.train_step import create_train_state as tcreate_state
from vgqa_tpu_torch.training.train_step import make_train_step as tmake_train_step
from vgqa_tpu_torch.utils.containers import TextBatch, VideoBatch

MAX_ITER = 100
LOSS_RTOL = 1e-4
GRAD_ATOL = 1e-4


def _cfgs():
    out = []
    for build in (jcfg_default, tcfg_default):
        cfg = build()
        cfg.MODEL.VSTG.DROPOUT = 0.0
        cfg.MODEL.VSTG.DEC_LAYERS = 2          # the tiny model's decoders
        out.append(cfg)
    return out


def _batch():
    rng = np.random.RandomState(11)
    V, T, H, W, L = 2, 6, 64, 64, 7
    frames = rng.randint(0, 256, (V, T, H, W, 3)).astype(np.uint8)
    pixel_mask = np.ones((V, H, W), bool)
    pixel_mask[1, :, 44:] = False
    time_mask = np.ones((V, T), bool)
    time_mask[1, 5] = False
    ids = rng.randint(4, 128, (V, L)).astype(np.int32)
    text_mask = np.ones((V, L), bool)
    text_mask[1, 5:] = False
    act = np.zeros((V, T), np.float32)
    act[0, 1:4] = 1
    act[1, 2:5] = 1
    boxes = np.concatenate([rng.rand(V, T, 2) * 0.5 + 0.25, rng.rand(V, T, 2) * 0.3 + 0.1],
                           -1).astype(np.float32)
    targets = {
        "boxes": boxes, "actioness": act, "time_mask": time_mask,
        "sted": np.array([[1, 3], [2, 4]], np.int32),
        "attr_labels": (rng.rand(V, 5) > 0.7).astype(np.float32),
        "verb_labels": (rng.rand(V, 7) > 0.7).astype(np.float32),
    }
    return frames, pixel_mask, time_mask, ids, text_mask, targets


def _jax_batch(b):
    frames, pm, tm, ids, tmask, targets = b
    return (JVideo(jnp.asarray(frames), jnp.asarray(pm), jnp.asarray(tm)),
            JText(jnp.asarray(ids), jnp.asarray(tmask)),
            {k: jnp.asarray(v) for k, v in targets.items()})


def _port_batch(b):
    frames, pm, tm, ids, tmask, targets = b
    t = {k: torch.from_numpy(v) for k, v in targets.items()}
    t["sted"] = t["sted"].long()
    return (VideoBatch(torch.from_numpy(frames), torch.from_numpy(pm), torch.from_numpy(tm)),
            TextBatch(torch.from_numpy(ids).long(), torch.from_numpy(tmask)), t)


@pytest.fixture(scope="module")
def jax_params():
    video, text, _ = _jax_batch(_batch())
    video = JVideo(video.frames.astype(jnp.float32), video.pixel_mask, video.time_mask)
    return random_params(JNet(JConfig.tiny_test()), video, text, seed=5)


def _losses():
    names = ["boxes", "sted", "logits_f_m", "logits_f_a", "logits_r_a", "logits_r_m",
             "actioness"]
    return (JLoss(sigma=2.0, eos_coef=0.1, losses=names),
            TLoss(sigma=2.0, eos_coef=0.1, losses=names))


def _port_name(path):
    """The port's state_dict name of a JAX leaf path (convert_jax's rule)."""
    keys = [getattr(k, "key", str(k)) for k in path]
    if keys[0] == "params":
        keys = keys[1:]
    if keys[-1] in ("kernel", "scale", "embedding"):
        keys[-1] = "weight"
    return ".".join(keys)


def _lr_bound(labels, cfg):
    s = cfg.SOLVER
    return {n: {"rest": s.BASE_LR, "vis": s.VIS_BACKBONE_LR, "text": s.TEXT_LR,
                "temp": s.TEMP_LR, "clas": s.VERB_LR, "frozen": 0.0}[g]
            for n, g in labels.items()}


@pytest.mark.parametrize("kernels", [False, True])
def test_train_step_matches_jax(jax_params, kernels, monkeypatch):
    monkeypatch.setenv("VGQA_PALLAS_INTERPRET", "1" if kernels else "0")
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(DropoutRng, "dropout", lambda self, x, rate: x)
    jcfg, tcfg = _cfgs()
    b = _batch()
    jloss, tloss = _losses()
    stats = (tuple(jcfg.INPUT.PIXEL_MEAN), tuple(jcfg.INPUT.PIXEL_STD))

    # ---- JAX: the gradients, then one step of make_train_step ----------
    jnet = JNet(dataclasses.replace(JConfig.tiny_test(), dropout=0.0,
                                    use_pallas_attention=kernels))
    video_j, text_j, targets_j = _jax_batch(b)
    key = jax.random.PRNGKey(0)
    wd_j = jweights(jcfg)

    def loss_of(params):
        out = jnet.apply(params, jnormalize(video_j, stats), text_j, train=True,
                         rngs={"dropout": key})
        losses = jloss(out, targets_j)
        return sum(losses[k] * wd_j[k] for k in losses if k in wd_j), losses

    (_, losses_j), grads_j = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(jax_params)
    tx, labels_j = make_optimizer(jcfg, jax_params, MAX_ITER)
    state_j = create_train_state(jax_params, tx, use_ema=True)
    step_j = jax.jit(jmake_train_step(jnet, jloss, wd_j, tx, jcfg.MODEL.EMA_DECAY,
                                      pixel_stats=stats))
    state_j, _ = step_j(state_j, video_j, text_j, targets_j, key)

    # ---- the port ------------------------------------------------------
    tnet = TNet(dataclasses.replace(TConfig.tiny_test(), dropout=0.0,
                                    use_pallas_attention=kernels))
    tnet.load_state_dict(state_dict_from_jax(jax_params, tnet))
    opt = GroupedAdamW(tcfg, tnet, MAX_ITER)
    state_t = tcreate_state(tnet, opt, use_ema=True)
    step_t = tmake_train_step(tloss, tweights(tcfg), tcfg.MODEL.EMA_DECAY, pixel_stats=stats)
    video_t, text_t, targets_t = _port_batch(b)
    _, losses_t = step_t.loss_and_grads(state_t, video_t, text_t, targets_t, seed=0)

    assert set(losses_t) == set(losses_j)
    for k in losses_j:
        np.testing.assert_allclose(float(losses_t[k]), float(losses_j[k]), rtol=LOSS_RTOL,
                                   atol=1e-6, err_msg=k)

    labels = {_port_name(p): lab for p, lab in
              jax.tree_util.tree_flatten_with_path(labels_j)[0]}
    grads_ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    n_compared = 0
    for name, p in tnet.named_parameters():
        if labels[name] == "frozen":
            assert p.grad is None and not p.requires_grad, name
            continue
        want = grads_ref[name].numpy()
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL * (1 + np.abs(want).max()),
                                   err_msg=name)
        n_compared += 1
    assert n_compared > 100

    step_t(state_t, video_t, text_t, targets_t, seed=0)
    new_ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state_j.params))
    ema_ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, state_j.ema_params))
    lr = _lr_bound(labels, tcfg)
    decay = tcfg.MODEL.EMA_DECAY
    for name, p in tnet.named_parameters():
        g = np.abs(grads_ref[name].numpy())
        noisy = g < max(1e-6, 1e-3 * g.max())
        tol = 5e-7 + lr[name] * np.where(noisy, 2.0, 1e-3)
        err = np.abs(p.detach().numpy() - new_ref[name].numpy())
        assert (err <= tol).all(), (name, float(err.max()))
        e_err = np.abs(state_t.ema[name].numpy() - ema_ref[name].numpy())
        assert e_err.max() <= 5e-7 + 2 * (1 - decay) * lr[name], name
    assert state_t.step == int(state_j.step) == 1
