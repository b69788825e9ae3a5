"""The per-block Video Swin routes of the port against vgqa_tpu: the window
helpers, ``compute_shift_mask``, ``WindowAttention3D``, ``DropPath`` and
``SwinBlock3D`` (the flax module route), the windowed block
``swin_block_fused`` (its plain version against the Pallas kernel in
interpret mode), ``fused_block_apply``, the backbone's ``module`` and
``blocks`` routes, which route ``VSTGNet`` takes, and one train step with a
trainable tower. Inputs and weights come from numpy and reach both packages
(weights through ``state_dict_from_jax``).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_swin_routes.py -q

Tolerances, float32 throughout:
- atol 5e-5, rtol 1e-4 where both sides run the same module arithmetic
  (one block: summation order only);
- the Pallas kernel against the plain versions: atol 1e-3 (the TPU kernel
  evaluates GELU through an erf polynomial with abs err 8.7e-5, skips the
  softmax max and takes LayerNorm statistics as E[x^2] - mu^2);
- four stages of blocks: atol 1e-4, rtol 1e-3 (as tests/test_pallas_window.py
  holds its own backbone routes);
- the train step: loss terms rtol 1e-4, gradients atol 1e-4 * (1 + max |g|)
  (~40 layers forward and backward, as tests/test_torch_train_step.py).
"""

import dataclasses

import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_kernels import _block_weights
from test_torch_modules import random_params, to_port
from test_torch_train_step import _batch, _cfgs, _jax_batch, _losses, _port_batch
from vgqa_tpu.models import GroundingConfig as JConfig
from vgqa_tpu.models import VSTGNet as JNet
from vgqa_tpu.models import video_swin as jvs
from vgqa_tpu.models.loss import build_weight_dict as jweights
from vgqa_tpu.ops.pallas.swin_block import swin_block_fused as pallas_swin_block_fused
from vgqa_tpu.utils.containers import TextBatch as JText
from vgqa_tpu.utils.containers import VideoBatch as JVideo
from vgqa_tpu.utils.containers import normalize_uint8_video as jnormalize
from vgqa_tpu_torch.models import GroundingConfig as TConfig
from vgqa_tpu_torch.models import VSTGNet as TNet
from vgqa_tpu_torch.models import video_swin as tvs
from vgqa_tpu_torch.models.convert_jax import state_dict_from_jax
from vgqa_tpu_torch.models.loss import build_weight_dict as tweights
from vgqa_tpu_torch.ops.dropout import DropoutRng
from vgqa_tpu_torch.ops.kernels import swin_block as tsb
from vgqa_tpu_torch.training.optimizer import GroupedAdamW
from vgqa_tpu_torch.training.train_step import create_train_state as tcreate_state
from vgqa_tpu_torch.training.train_step import make_train_step as tmake_train_step
from vgqa_tpu_torch.utils.containers import TextBatch, VideoBatch

ATOL, RTOL = 5e-5, 1e-4
KERNEL_ATOL = 1e-3
DEEP_ATOL, DEEP_RTOL = 1e-4, 1e-3


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _close(out, ref, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=atol, rtol=rtol)


@pytest.mark.parametrize("shape,window", [((2, 4, 6, 6, 3), (2, 3, 2)),
                                          ((1, 8, 14, 7, 5), (8, 7, 7))])
def test_window_partition_reverse(shape, window):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    win_t = tvs.window_partition(_t(x), window)
    np.testing.assert_array_equal(win_t.numpy(), np.asarray(jvs.window_partition(_j(x), window)))
    B, D, H, W, _ = shape
    back_j = jvs.window_reverse(_j(win_t.numpy()), window, B, D, H, W)
    back_t = tvs.window_reverse(win_t, window, B, D, H, W)
    np.testing.assert_array_equal(back_t.numpy(), np.asarray(back_j))
    np.testing.assert_array_equal(back_t.numpy(), x)


# (dims, full window, full shift): unclamped, a clamped window, no shift
@pytest.mark.parametrize("dims,window,shift", [((4, 6, 6), (2, 2, 2), (1, 1, 1)),
                                               ((3, 14, 5), (8, 7, 7), (4, 3, 3)),
                                               ((4, 6, 6), (2, 2, 2), (0, 0, 0))])
def test_compute_shift_mask(dims, window, shift):
    window, shift = tvs._adjust_window(dims, window, shift)
    assert (window, shift) == jvs._adjust_window(dims, window, shift)
    padded = tuple(d + (-d) % w for d, w in zip(dims, window))
    got = tvs.compute_shift_mask(padded, window, shift)
    want = jvs.compute_shift_mask(padded, window, shift)
    if not any(shift):
        assert got is None and want is None
        return
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) == {-100.0, 0.0}


@pytest.mark.parametrize("masked", [False, True])
def test_window_attention_3d(masked):
    """Full window (2, 3, 3) with windows of N = 8 (a clamped window reads
    the bias index's [:8, :8] corner); masked: 2 clips x 4 windows."""
    rng = np.random.RandomState(1)
    x = rng.randn(8, 8, 16).astype(np.float32)
    mask = None
    if masked:
        mask = np.asarray(jvs.compute_shift_mask((2, 4, 4), (2, 2, 2), (1, 1, 1)))
    jm = jvs.WindowAttention3D(16, (2, 3, 3), 2)
    params = random_params(jm, _j(x), _j(mask))
    want = jm.apply(params, _j(x), _j(mask))
    tm, _ = to_port(tvs.WindowAttention3D(16, (2, 3, 3), 2), params)
    with torch.no_grad():
        _close(tm(_t(x), _t(mask)), want)


def _block_pair(shift, x, seed=0):
    jm = jvs.SwinBlock3D(dim=8, num_heads=2, window=(2, 2, 2), shift=shift)
    params = random_params(jm, _j(x), seed=seed)
    tm, _ = to_port(tvs.SwinBlock3D(8, 2, (2, 2, 2), shift), params)
    return jm, params, tm


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 1, 1)])
@pytest.mark.parametrize("dims", [(1, 4, 6, 6), (1, 3, 5, 7)])
def test_swin_block_3d(dims, shift):
    """The cases of tests/test_pallas_window.py's fused-block tests: plain
    and shifted windows, and odd dims that pad after LN1."""
    x = np.random.RandomState(3).randn(*dims, 8).astype(np.float32)
    jm, params, tm = _block_pair(shift, x)
    with torch.no_grad():
        _close(tm(_t(x)), jm.apply(params, _j(x)))


@pytest.mark.parametrize("case", ["rate0", "deterministic", "train"])
def test_drop_path(case):
    x = np.random.RandomState(4).randn(64, 3, 4).astype(np.float32)
    rate = 0.0 if case == "rate0" else 0.5
    deterministic = case == "deterministic"
    apply = flax.linen.apply(lambda m, a: m(a, deterministic), jvs.DropPath(rate))
    want = apply({}, _j(x), rngs={"dropout": jax.random.PRNGKey(0)})
    got = tvs.DropPath(rate)(_t(x), deterministic, DropoutRng(0, "cpu"))
    if case != "train":
        np.testing.assert_array_equal(got.numpy(), x)
        np.testing.assert_array_equal(np.asarray(want), x)
        return
    # the draws differ (torch generator vs JAX key): hold both to the rule,
    # each sample kept and scaled by 1 / keep, or zeroed, and both outcomes seen
    for out in (got.numpy(), np.asarray(want)):
        kept = np.array([np.allclose(o, xi / 0.5, rtol=1e-6) for o, xi in zip(out, x)])
        dropped = np.array([not o.any() for o in out])
        assert (kept ^ dropped).all()
        assert kept.any() and dropped.any()
    with pytest.raises(ValueError):
        tvs.DropPath(rate)(_t(x), False, None)


# (W, N, C, heads, region rows, valid rows)
FUSED_CASES = {
    "plain": (4, 8, 8, 2, None, None),
    "region": (4, 8, 8, 2, 4, None),
    "region_valid_tiled": (6, 8, 16, 2, 2, 3),
    "swin_window": (2, 392, 64, 2, 2, 2),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_swin_block_fused_matches_pallas(case):
    W, N, C, heads, r_rows, v_rows = FUSED_CASES[case]
    rng = np.random.RandomState(20 + sorted(FUSED_CASES).index(case))
    x = rng.randn(W, N, C).astype(np.float32)
    ws = _block_weights(rng, C)
    bias = (rng.randn(heads, N, N) * 0.2).astype(np.float32)
    region = None if r_rows is None else rng.randint(0, 3, (r_rows, N)).astype(np.int32)
    valid = None
    if v_rows is not None:
        valid = (rng.rand(v_rows, N) > 0.3).astype(np.float32)
        valid[:, 0] = 1.0
    want = pallas_swin_block_fused(_j(x), *map(_j, ws), _j(bias), heads, region=_j(region),
                                   valid=_j(valid), interpret=True)
    args = (_t(x), *map(_t, ws), _t(bias), heads)
    got = tsb.swin_block_fused(*args, region=_t(region), valid=_t(valid))
    np.testing.assert_array_equal(
        got.numpy(), tsb.swin_block_fused_reference(*args, _t(region), _t(valid)).numpy())
    _close(got, want, atol=KERNEL_ATOL, rtol=0)


def test_fused_block_on_partitioned_canvas_is_the_canvas_block():
    """The windowed block on partition(roll(canvas)) is the canvas block
    (the same math with other row maps), shifted and padded."""
    rng = np.random.RandomState(30)
    dims, window, shift = (3, 5, 6), (2, 2, 2), (1, 1, 1)
    padded = tuple(d + (-d) % w for d, w in zip(dims, window))
    canvas = _t(rng.randn(2, *padded, 8).astype(np.float32))
    ws = [_t(w) for w in _block_weights(rng, 8)]
    bias = _t((rng.randn(2, 8, 8) * 0.2).astype(np.float32))
    region = _t(tvs._region_partition(padded, window, shift))
    valid = _t(tvs._valid_partition(dims, padded, window, shift))
    want = tsb.swin_block_canvas(canvas, *ws, bias, 2, window, shift, region=region,
                                 valid=valid)
    rolled = torch.roll(canvas, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
    got = tsb.swin_block_fused(tvs.window_partition(rolled, window), *ws, bias, 2,
                               region=region, valid=valid)
    _close(tvs.window_reverse(got, window, 2, *padded), want)


@pytest.mark.parametrize("shift", [(0, 0, 0), (1, 1, 1)])
@pytest.mark.parametrize("dims", [(1, 4, 6, 6), (1, 3, 5, 7)])
def test_fused_block_apply(dims, shift):
    """Against JAX ``fused_block_apply`` (Pallas in interpret mode) and the
    port's own ``SwinBlock3D`` on the same weights."""
    x = np.random.RandomState(5).randn(*dims, 8).astype(np.float32)
    jm, params, tm = _block_pair(shift, x, seed=1)
    want = jvs.fused_block_apply(_j(x), params["params"], (2, 2, 2), shift, 2,
                                 interpret=True)
    with torch.no_grad():
        got = tvs.fused_block_apply(_t(x), tm, (2, 2, 2), shift, 2)
        _close(got, want, atol=KERNEL_ATOL, rtol=0)
        _close(got, tm(_t(x)).numpy())


@pytest.mark.parametrize("route", ["module", "blocks"])
def test_backbone_route_matches_module(route):
    """The backbone's per-block routes against ``VideoSwinBackbone.apply``
    on ``video_swin_test`` at odd spatial dims (stage 0 pads)."""
    x = np.random.RandomState(6).randn(1, 3, 20, 12, 3).astype(np.float32)
    cfg = jvs.VideoSwinConfig.tiny_test()
    jm = jvs.VideoSwinBackbone(cfg)
    params = random_params(jm, _j(x))
    want = jax.jit(jm.apply)(params, _j(x))
    tm, _ = to_port(tvs.VideoSwinBackbone(tvs.VideoSwinConfig.tiny_test()), params)
    with torch.no_grad():
        got = tm(_t(x), route=route)
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], DEEP_ATOL, DEEP_RTOL)
    with pytest.raises(ValueError):
        tm(_t(x), route="windows")


def _tiny_inputs(V=2, T=3):
    rng = np.random.RandomState(7)
    frames = rng.randn(V, T, 64, 64, 3).astype(np.float32)
    ids = rng.randint(4, 128, (V, 5)).astype(np.int32)
    return (VideoBatch(_t(frames), torch.ones(V, 64, 64, dtype=torch.bool),
                       torch.ones(V, T, dtype=torch.bool)),
            TextBatch(_t(ids).long(), torch.ones(V, 5, dtype=torch.bool)))


# (use_pallas_attention, train, freeze_swin) -> (route, tower under autograd)
ROUTE_CASES = {
    "serve_kernels": ((True, False, True), ("canvas", False)),
    "train_frozen_kernels": ((True, True, True), ("canvas", False)),
    "train_trainable_kernels": ((True, True, False), ("module", True)),
    "serve_plain": ((False, False, True), ("module", False)),
    "train_frozen_plain": ((False, True, True), ("module", False)),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_vstgnet_takes_the_route(case, monkeypatch):
    """The conditions of vgqa_tpu/models/vstgnet.py's tower branch: the
    canvas route with the kernel routes on in eval or for a frozen tower,
    the module route otherwise; a frozen tower runs without gradient."""
    (pallas, train, freeze), want = ROUTE_CASES[case]
    seen = []
    forward = tvs.VideoSwinBackbone.forward

    def spy(self, frames, gates=None, route="canvas", rng=None):
        seen.append((route, torch.is_grad_enabled(), gates is not None, rng is not None))
        return forward(self, frames, gates, route, rng)

    monkeypatch.setattr(tvs.VideoSwinBackbone, "forward", spy)
    torch.manual_seed(0)
    net = TNet(dataclasses.replace(TConfig.tiny_test(), use_pallas_attention=pallas,
                                   freeze_swin=freeze, dropout=0.0))
    video, text = _tiny_inputs()
    out = net(video, text, train=train, rng=DropoutRng(0, "cpu") if train else None)
    assert [s[:2] for s in seen] == [want]
    assert not seen[0][2]                       # the tiny tower's drop_path_rate is 0
    assert seen[0][3] == (train and want[0] == "module")
    assert torch.isfinite(out["pred_boxes"]).all()


def test_vstgnet_module_route_serving_matches_jax():
    """The tiny VSTGNet with TPU.USE_PALLAS_ATTENTION False (both packages on
    their module route) from one parameter tree."""
    video, text = _tiny_inputs()
    cfg = dataclasses.replace(JConfig.tiny_test(), use_pallas_attention=False)
    jnet = JNet(cfg)
    vj = JVideo(_j(video.frames.numpy()), _j(video.pixel_mask.numpy()),
                _j(video.time_mask.numpy()))
    tj = JText(_j(text.token_ids.numpy().astype(np.int32)), _j(text.mask.numpy()))
    params = random_params(jnet, vj, tj, seed=8)
    want = jax.jit(lambda p: jnet.apply(p, vj, tj))(params)
    tnet, _ = to_port(TNet(dataclasses.replace(TConfig.tiny_test(),
                                               use_pallas_attention=False)), params)
    with torch.no_grad():
        got = tnet(video, text)
    for k in ("pred_boxes", "pred_sted", "att_sequences"):
        _close(got[k], want[k], atol=1e-3, rtol=0)


def test_train_step_trainable_tower(monkeypatch):
    """One step with MODEL.VIDEO_SWIN.FREEZE False and every dropout rate 0
    (the tiny tower's drop_path_rate is 0; the fixed-rate dropouts become
    the identity), against the JAX step's loss: every loss term, and the
    gradient of every Swin leaf."""
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, x, deterministic=None, rng=None: x)
    monkeypatch.setattr(DropoutRng, "dropout", lambda self, x, rate: x)
    jcfg, tcfg = _cfgs()
    jcfg.MODEL.VIDEO_SWIN.FREEZE = tcfg.MODEL.VIDEO_SWIN.FREEZE = False
    b = _batch()
    jloss, tloss = _losses()
    stats = (tuple(jcfg.INPUT.PIXEL_MEAN), tuple(jcfg.INPUT.PIXEL_STD))
    video_j, text_j, targets_j = _jax_batch(b)
    params = random_params(JNet(JConfig.tiny_test()),
                           JVideo(video_j.frames.astype(jnp.float32), video_j.pixel_mask,
                                  video_j.time_mask), text_j, seed=9)

    jnet = JNet(dataclasses.replace(JConfig.tiny_test(), dropout=0.0, freeze_swin=False))
    wd_j = jweights(jcfg)

    def loss_of(p):
        out = jnet.apply(p, jnormalize(video_j, stats), text_j, train=True,
                         rngs={"dropout": jax.random.PRNGKey(0)})
        losses = jloss(out, targets_j)
        return sum(losses[k] * wd_j[k] for k in losses if k in wd_j), losses

    (_, losses_j), grads_j = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(params)

    tnet = TNet(dataclasses.replace(TConfig.tiny_test(), dropout=0.0, freeze_swin=False))
    tnet.load_state_dict(state_dict_from_jax(params, tnet))
    state = tcreate_state(tnet, GroupedAdamW(tcfg, tnet, 100), use_ema=False)
    step = tmake_train_step(tloss, tweights(tcfg), None, pixel_stats=stats)
    _, losses_t = step.loss_and_grads(state, *_port_batch(b), seed=0)

    for k in losses_j:
        np.testing.assert_allclose(float(losses_t[k]), float(losses_j[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    grads = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads_j))
    swin = [(n, p) for n, p in tnet.named_parameters() if n.startswith("vid.")]
    assert len(swin) > 40
    for name, p in swin:
        want = grads[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want,
                                   atol=1e-4 * (1 + np.abs(want).max()), err_msg=name)
    assert max(float(p.grad.abs().max()) for _, p in swin) > 1e-4
