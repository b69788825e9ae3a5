"""The train-mode modules of the port that hold a kernel or a gradient path
against vgqa_tpu on the CPU, float32: the cross-modal encoder in training
(its self-attention on the K3 route, JAX in interpret mode, and on the
einsum route), the ResNet's gradients through the FrozenAffine fold, and
the Swin tower with DropPath gates (the K1 plain version against the
Pallas canvas kernel in interpret mode); then the port's own remat and
dropout.

Tolerances: atol 1e-4 on outputs and gradients of the encoder (two f32
layers, another summation order), 1e-3 * (1 + max |g|) on the ResNet's
gradients (a deep conv stack) and 1e-3 on the Swin outputs (as the
module-parity tests of the serving path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_modules import random_params, to_port
from vgqa_tpu.models import encoder as jenc
from vgqa_tpu.models import resnet as jres
from vgqa_tpu.models import video_swin as jvs
from vgqa_tpu_torch.models import encoder as tenc
from vgqa_tpu_torch.models import resnet as tres
from vgqa_tpu_torch.models import video_swin as tvs
from vgqa_tpu_torch.models.convert_jax import state_dict_from_jax
from vgqa_tpu_torch.ops.dropout import DropoutRng
from vgqa_tpu_torch.ops.kernels.flash_train import flash_mha_train


def _encoder_inputs(seed=6, V=2, T=3, hw=6, L=5, d=32):
    rng = np.random.RandomState(seed)
    vis = rng.randn(V, T, hw, d).astype(np.float32)
    swin = rng.randn(V, T, hw, d).astype(np.float32)
    text = rng.randn(V, L, d).astype(np.float32)
    pos = rng.randn(V, hw, d).astype(np.float32)
    vis_mask = rng.rand(V, hw) > 0.3
    text_mask = np.ones((V, L), bool)
    text_mask[1, 3:] = False
    time_mask = np.ones((V, T), bool)
    cot = rng.randn(V, T, 2 * hw + L, d).astype(np.float32)
    return (vis, swin, text, pos, vis_mask, text_mask, time_mask), cot


@pytest.mark.parametrize("use_flash", [False, True])
def test_encoder_train_matches_jax(use_flash, monkeypatch):
    monkeypatch.setenv("VGQA_PALLAS_INTERPRET", "1")
    inputs, cot = _encoder_inputs()
    jm = jenc.CrossModalEncoder(2, 4, 64, dropout=0.0, use_flash=use_flash)
    jin = [jnp.asarray(a) for a in inputs]
    params = random_params(jm, *jin)

    def jloss(p, vis, swin, text):
        out = jm.apply(p, vis, swin, text, *jin[3:], deterministic=False,
                       rngs={"dropout": jax.random.PRNGKey(0)})
        return (out["encoded"] * cot).sum()

    gp_j, *gx_j = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(params, *jin[:3])
    tm, _ = to_port(tenc.CrossModalEncoder(32, 2, 4, 64, use_flash=use_flash, dropout=0.0),
                    params)
    xs = [torch.from_numpy(a).requires_grad_() for a in inputs[:3]]
    fwd0 = flash_mha_train.fwd_launches
    out = tm(*xs, *[torch.from_numpy(a) for a in inputs[3:]], rng=DropoutRng(0, "cpu"))
    (out["encoded"] * torch.from_numpy(cot)).sum().backward()
    assert flash_mha_train.fwd_launches == fwd0       # CPU tensors: the plain version
    for a, b in zip(xs, gx_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), atol=1e-4)
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, gp_j))
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n].numpy(), atol=1e-4, err_msg=n)


def test_resnet_grads_through_frozen_affine_fold():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 64, 48, 3).astype(np.float32)
    jm = jres.build_resnet("resnet_test")
    params = random_params(jm, jnp.asarray(x))
    out_j = jm.apply(params, jnp.asarray(x))
    cot = rng.randn(*out_j.shape).astype(np.float32)
    g_j = jax.grad(lambda p: (jm.apply(p, jnp.asarray(x)) * cot).sum())(params)
    tm, _ = to_port(tres.build_resnet("resnet_test"), params)
    (tm(torch.from_numpy(x)) * torch.from_numpy(cot)).sum().backward()
    want = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, g_j))
    names = [n for n, _ in tm.named_parameters()]
    assert any(n.endswith("bn1.weight") for n in names) and any("conv2" in n for n in names)
    for n, p in tm.named_parameters():
        w = want[n].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-3 * (1 + np.abs(w).max()),
                                   err_msg=n)


def test_swin_drop_path_gates_match_pallas():
    cfg_j = jvs.VideoSwinConfig.tiny_test()
    rng = np.random.RandomState(4)
    x = rng.randn(2, 4, 32, 16, 3).astype(np.float32)
    jm = jvs.VideoSwinBackbone(cfg_j)
    params = random_params(jm, jnp.asarray(x))
    gates = np.where(rng.rand(4, 2, 2) > 0.3, 1.25, 0.0).astype(np.float32)
    gates[0] = 1.0
    out_j = jax.jit(lambda p, a, g: jvs.fused_backbone_apply(
        p, a, cfg_j, interpret=True, drop_path_gates=g))(params["params"], jnp.asarray(x),
                                                         jnp.asarray(gates))
    tm, _ = to_port(tvs.VideoSwinBackbone(tvs.VideoSwinConfig.tiny_test()), params)
    with torch.no_grad():
        out_t = tm(torch.from_numpy(x), gates=torch.from_numpy(gates))
        plain = tm(torch.from_numpy(x))
    for k in out_j:
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]), atol=1e-3)
    assert np.abs(out_t["3"].numpy() - plain["3"].numpy()).max() > 1e-2


def test_drop_path_gate_sampling():
    tm = tvs.VideoSwinBackbone(tvs.VideoSwinConfig())          # Swin-T, rate 0.2
    g = tm.drop_path_gates(DropoutRng(0, "cpu"), batch=4000, device="cpu")
    keep = 1.0 - np.linspace(0.0, 0.2, 12)
    assert g.shape == (12, 4000, 2)
    for b in range(12):
        vals = np.unique(g[b].numpy())
        assert np.isin(vals.round(4), [0.0, np.float32(1.0 / keep[b]).round(4)]).all()
        assert abs(float((g[b] > 0).float().mean()) - keep[b]) < 0.02
    assert tvs.VideoSwinBackbone(tvs.VideoSwinConfig.tiny_test()).drop_path_gates(
        DropoutRng(0, "cpu"), 2, "cpu") is None


def test_remat_encoder_matches_plain_with_dropout():
    """Per-layer checkpointing recomputes each layer in the backward with the
    forward's dropout masks and K3 seeds: grads equal the plain run's."""
    inputs, cot = _encoder_inputs(seed=9)
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        tm = tenc.CrossModalEncoder(32, 2, 4, 64, use_flash=True, dropout=0.1, remat=remat)
        xs = [torch.from_numpy(a).requires_grad_() for a in inputs[:3]]
        out = tm(*xs, *[torch.from_numpy(a) for a in inputs[3:]], rng=DropoutRng(7, "cpu"))
        (out["encoded"] * torch.from_numpy(cot)).sum().backward()
        grads.append([x.grad for x in xs] + [p.grad for p in tm.parameters()])
    for a, b in zip(*grads):
        assert torch.allclose(a, b, atol=1e-6)


def test_dropout_rng():
    rng = DropoutRng(3, "cpu")
    x = torch.ones(200_000)
    y = rng.dropout(x, 0.1)
    vals = torch.unique(y)
    assert len(vals) == 2 and vals[0] == 0 and abs(float(vals[1]) - 1 / 0.9) < 1e-6
    assert abs(float((y > 0).float().mean()) - 0.9) < 0.005
    assert rng.dropout(x, 0.0) is x
    s = rng.seed()
    assert -2 ** 31 <= s < 2 ** 31
    state = rng.get_state()
    a = rng.dropout(x, 0.5)
    rng.set_state(state)
    assert torch.equal(a, rng.dropout(x, 0.5))
