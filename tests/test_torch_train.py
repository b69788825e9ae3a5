"""The training pieces of the port against vgqa_tpu on the CPU: the loss
(every term), the parameter labels, the learning-rate schedules, one and
two clipped AdamW + EMA updates on fixed gradients against optax; then the
port on its own: the bf16 mixed-precision step, a Swin tower that trains,
checkpoint resume, and the
synthetic-batch trainer with the JAX stack, YAML, OpenCV and vgqa_tpu
unimportable.

Tolerances (float32): loss terms rtol 1e-5 (the same formulas); schedules
rel 1e-6 (JAX computes them in float32, the port in float64); the updated
parameters and EMA atol 2.5e-7 (2 f32 ulps at |p| ~ 1) + 1e-5 * lr of the
group and the moments
rtol 1e-5 (Adam's first steps are +-lr per element, so the only
differences are f32 rounding of the same operations in another order).
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_modules import random_params
from vgqa_tpu.config import build_default_cfg as jcfg_default
from vgqa_tpu.models import GroundingConfig as JConfig
from vgqa_tpu.models import VSTGNet as JNet
from vgqa_tpu.models.loss import VideoSTGLoss as JLoss
from vgqa_tpu.models.loss import build_weight_dict as jweights
from vgqa_tpu.training import label_params as jlabel_params
from vgqa_tpu.training import make_optimizer, make_schedule as jschedule, update_ema as jema
from vgqa_tpu.utils.containers import TextBatch as JText
from vgqa_tpu.utils.containers import VideoBatch as JVideo
from vgqa_tpu_torch.config import build_default_cfg as tcfg_default
from vgqa_tpu_torch.models import GroundingConfig as TConfig
from vgqa_tpu_torch.models import VSTGNet as TNet
from vgqa_tpu_torch.models.convert_jax import state_dict_from_jax
from vgqa_tpu_torch.models.loss import VideoSTGLoss as TLoss
from vgqa_tpu_torch.models.loss import build_weight_dict as tweights
from vgqa_tpu_torch.training.optimizer import (
    GROUPS,
    GroupedAdamW,
    label_params,
    make_schedule,
    update_ema,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_OPTS = [
    "INPUT.RESOLUTION", "64", "INPUT.TRAIN_SAMPLE_NUM", "4",
    "MODEL.VISION_BACKBONE.NAME", "resnet_test",
    "MODEL.VIDEO_SWIN.MODEL_NAME", "video_swin_test", "MODEL.VIDEO_SWIN.FEATURE_DIM", "64",
    "MODEL.TEXT_MODEL.NUM_LAYERS", "2", "MODEL.VSTG.HIDDEN", "32", "MODEL.VSTG.HEADS", "4",
    "MODEL.VSTG.ENC_LAYERS", "2", "MODEL.VSTG.DEC_LAYERS", "2", "MODEL.VSTG.FFN_DIM", "64",
]


def _port_name(path):
    keys = [getattr(k, "key", str(k)) for k in path]
    if keys[0] == "params":
        keys = keys[1:]
    if keys[-1] in ("kernel", "scale", "embedding"):
        keys[-1] = "weight"
    return ".".join(keys)


@pytest.fixture(scope="module")
def tiny():
    """A random tiny parameter tree and the port model that holds it."""
    video = JVideo(jnp.zeros((1, 2, 64, 64, 3)), jnp.ones((1, 64, 64), bool),
                   jnp.ones((1, 2), bool))
    text = JText(jnp.ones((1, 5), jnp.int32), jnp.ones((1, 5), bool))
    params = random_params(JNet(JConfig.tiny_test()), video, text, seed=8)
    return params


def _tiny_port(params):
    net = TNet(TConfig.tiny_test())
    net.load_state_dict(state_dict_from_jax(params, net))
    return net


def _outputs_targets(seed=0, V=2, T=7, aux=2):
    rng = np.random.RandomState(seed)

    def head():
        return {"pred_boxes": (rng.rand(V, T, 4) * 0.5 + 0.2).astype(np.float32),
                "pred_sted": rng.randn(V, T, 2).astype(np.float32) * 2,
                "pred_actioness": rng.randn(V, T, 1).astype(np.float32)}

    out = head()
    out.update({k: rng.randn(V, T).astype(np.float32) for k in ("logits_f_m", "logits_f_a")})
    out["logits_r_a"] = rng.randn(V, 5).astype(np.float32)
    out["logits_r_m"] = rng.randn(V, 6).astype(np.float32)
    out["aux_outputs"] = [head() for _ in range(aux)]
    tm = np.ones((V, T), bool)
    tm[1, 5:] = False
    act = np.zeros((V, T), np.float32)
    act[0, 2:5] = 1
    act[1, 1:3] = 1
    targets = {"boxes": (rng.rand(V, T, 4) * 0.4 + 0.2).astype(np.float32), "actioness": act,
               "time_mask": tm, "sted": np.array([[2, 4], [1, 2]], np.int32),
               "attr_labels": (rng.rand(V, 5) > 0.5).astype(np.float32),
               "verb_labels": (rng.rand(V, 6) > 0.5).astype(np.float32)}
    return out, targets


def _tree(f, x):
    if isinstance(x, dict):
        return {k: _tree(f, v) for k, v in x.items()}
    if isinstance(x, list):
        return [_tree(f, v) for v in x]
    return f(x)


def test_loss_matches_jax():
    out, targets = _outputs_targets()
    jl = JLoss(sigma=2.0, eos_coef=0.1)(_tree(jnp.asarray, out), _tree(jnp.asarray, targets))
    tt = _tree(torch.from_numpy, targets)
    tt["sted"] = tt["sted"].long()
    tl = TLoss(sigma=2.0, eos_coef=0.1)(_tree(torch.from_numpy, out), tt)
    assert set(tl) == set(jl) and len(tl) == 8 + 2 * 4
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert tweights(tcfg_default()) == jweights(jcfg_default())


def test_labels_match_jax(tiny):
    for freeze_swin, freeze_text in ((True, False), (False, True)):
        want = {_port_name(p): lab for p, lab in jax.tree_util.tree_flatten_with_path(
            jlabel_params(tiny, freeze_swin, freeze_text))[0]}
        net = _tiny_port(tiny)
        got = label_params(dict(net.named_parameters()), freeze_swin, freeze_text)
        assert got == want
        assert set(got.values()) == set(GROUPS) - ({"text"} if freeze_text else set())


@pytest.mark.parametrize("sched", ["multistep_with_warmup_all", "multistep_with_warmup"])
def test_schedule_matches_jax(sched):
    cfgs = []
    for build in (jcfg_default, tcfg_default):
        cfg = build()
        cfg.SOLVER.SCHEDULE.TYPE = sched
        cfg.SOLVER.MAX_EPOCH = 5
        cfg.SOLVER.SCHEDULE.DROP_STEP = [2, 4]
        cfg.SOLVER.WARMUP_PROP = 0.05
        cfgs.append(cfg)
    for group in GROUPS[:-1]:
        j, t = jschedule(cfgs[0], 200, group), make_schedule(cfgs[1], 200, group)
        for step in range(50):
            np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-6,
                                       err_msg=f"{group} {step}")


def test_adamw_clip_ema_match_optax(tiny):
    jcfg, tcfg = jcfg_default(), tcfg_default()
    rng = np.random.RandomState(3)
    tx, labels = make_optimizer(jcfg, tiny, 100)
    opt_state = tx.init(tiny)
    params_j, ema_j = tiny, jax.tree_util.tree_map(jnp.asarray, tiny)
    net = _tiny_port(tiny)
    opt = GroupedAdamW(tcfg, net, 100)
    ema_t = {n: p.detach().clone() for n, p in net.named_parameters()}
    lab = {_port_name(p): g for p, g in jax.tree_util.tree_flatten_with_path(labels)[0]}
    s = tcfg.SOLVER
    lr = {"rest": s.BASE_LR, "vis": s.VIS_BACKBONE_LR, "text": s.TEXT_LR, "temp": s.TEMP_LR,
          "clas": s.VERB_LR, "frozen": 0.0}
    decay = tcfg.MODEL.EMA_DECAY
    for step, gscale in enumerate((1.0, 1e-3)):    # a clipped step, then an unclipped one
        grads = jax.tree_util.tree_map(
            lambda a: (gscale * rng.randn(*a.shape)).astype(np.float32), tiny)
        updates, opt_state = tx.update(grads, opt_state, params_j)
        params_j = optax.apply_updates(params_j, updates)
        ema_j = jema(params_j, ema_j, decay)
        g_t = state_dict_from_jax(grads)
        for n, p in net.named_parameters():
            p.grad = g_t[n].clone() if p.requires_grad else None
        opt.step(step)
        update_ema(dict(net.named_parameters()), ema_t, decay)
        want_p = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, params_j))
        want_e = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, ema_j))
        for n, p in net.named_parameters():
            tol = 2.5e-7 + 1e-5 * lr[lab[n]]
            np.testing.assert_allclose(p.detach().numpy(), want_p[n].numpy(), atol=tol,
                                       rtol=0, err_msg=f"step {step} {n}")
            np.testing.assert_allclose(ema_t[n].numpy(), want_e[n].numpy(), atol=tol,
                                       rtol=0, err_msg=f"ema step {step} {n}")
    # the moments after two steps
    mu = {}
    for inner in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(
            x, optax.ScaleByAdamState)):
        if isinstance(inner, optax.ScaleByAdamState):
            for p, leaf in jax.tree_util.tree_flatten_with_path(inner.mu)[0]:
                if not isinstance(leaf, optax.MaskedNode):
                    leaf = np.asarray(leaf)
                    if getattr(p[-1], "key", "") == "kernel":     # [in, out] -> [out, in]
                        leaf = leaf.T if leaf.ndim == 2 else leaf.transpose(3, 2, 0, 1)
                    mu[_port_name(p)] = leaf
    assert set(mu) == set(opt.m)
    for n, m in opt.m.items():
        np.testing.assert_allclose(m.numpy(), mu[n], rtol=1e-5, atol=1e-9, err_msg=n)


def _tiny_cfg(*extra):
    cfg = tcfg_default()
    cfg.merge_from_list(TINY_OPTS + list(extra))
    cfg.freeze()
    return cfg


def test_bf16_step_keeps_f32_masters_and_frozen_leaves():
    from vgqa_tpu_torch.data.synthetic_batch import synthetic_batch
    from vgqa_tpu_torch.training.trainer import Trainer

    cfg = _tiny_cfg("TPU.TRAIN_DTYPE", "bfloat16")
    trainer = Trainer(cfg, device="cpu", seed=1)
    trainer.setup(max_iter=10)
    model = trainer.state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    labels = trainer.state.optimizer.labels
    logged = trainer.fit([synthetic_batch(cfg)], steps=2)
    assert all(np.isfinite(m["loss"]) for m in logged)
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32, n
        if labels[n] == "frozen":
            assert torch.equal(p, before[n]), n
    changed = [n for n, p in model.named_parameters()
               if labels[n] != "frozen" and not torch.equal(p, before[n])]
    assert len(changed) > 0.9 * sum(1 for n in labels if labels[n] != "frozen")
    assert all(e.dtype == torch.float32 for e in trainer.state.ema.values())
    assert not torch.equal(trainer.state.ema["input_proj.weight"], before["input_proj.weight"])


def test_unfrozen_swin_trains_through_the_plain_blocks():
    """MODEL.VIDEO_SWIN.FREEZE False: the tower's blocks run their plain
    (differentiable) version in training, and its parameters train."""
    from vgqa_tpu_torch.data.synthetic_batch import synthetic_batch
    from vgqa_tpu_torch.training.trainer import Trainer

    cfg = _tiny_cfg("MODEL.VIDEO_SWIN.FREEZE", "False")
    trainer = Trainer(cfg, device="cpu", seed=2)
    trainer.setup(max_iter=10)
    vid = {n: p.detach().clone() for n, p in trainer.state.model.named_parameters()
           if n.startswith("vid.")}
    assert {trainer.state.optimizer.labels[n] for n in vid} == {"rest"}
    trainer.fit([synthetic_batch(cfg)], steps=1)
    params = dict(trainer.state.model.named_parameters())
    assert sum(not torch.equal(params[n], v) for n, v in vid.items()) > 0.9 * len(vid)


def test_checkpoint_resume_matches_uninterrupted_run(tmp_path):
    from vgqa_tpu_torch.data.synthetic_batch import synthetic_batch
    from vgqa_tpu_torch.training.trainer import Trainer

    def run(out_dir, steps):
        cfg = _tiny_cfg("OUTPUT_DIR", str(out_dir))
        trainer = Trainer(cfg, device="cpu", seed=4)
        trainer.setup(max_iter=10)
        trainer.fit([synthetic_batch(cfg)], steps=steps)
        return trainer.state

    full = run(tmp_path / "a", 2)
    run(tmp_path / "b", 1)
    assert (tmp_path / "b" / "last_checkpoint").read_text().endswith("model_final")
    resumed = run(tmp_path / "b", 1)          # resumes at step 1, takes step 2
    assert resumed.step == full.step == 2
    for (n, p), (_, q) in zip(full.model.named_parameters(),
                              resumed.model.named_parameters()):
        assert torch.equal(p, q), n
    for n in full.ema:
        assert torch.equal(full.ema[n], resumed.ema[n]), n
    for n in full.optimizer.v:
        assert torch.equal(full.optimizer.v[n], resumed.optimizer.v[n]), n


_BLOCKED_TRAINER = textwrap.dedent("""
    import importlib.abc, sys

    BLOCKED = {"jax", "jaxlib", "flax", "optax", "yaml", "cv2", "vgqa_tpu"}

    class Refuse(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is not installed on the card machine")
            return None

    sys.meta_path.insert(0, Refuse())
    from vgqa_tpu_torch.training.trainer import main

    main(["--steps", "2", "--device", "cpu", *sys.argv[1:]])
    assert not [m for m in sys.modules if m.split(".")[0] in BLOCKED]
    print("TRAINED")
""")


def test_trainer_cli_without_jax_yaml_cv2():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_TRAINER, *TINY_OPTS],
                          capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TRAINED" in proc.stdout
    assert proc.stderr.count("iter ") == 2         # the loss terms of both steps
