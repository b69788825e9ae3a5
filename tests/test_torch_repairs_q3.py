"""The two port faults of ROADMAP Queue 3 (items 1-2), repaired:

1. one float32 precision policy, set by the port's entry points
   (``utils/device.apply_precision_policy``: TF32 off in cuBLAS and cuDNN);
2. the kernel wrappers take head dims below their kernel's by zero-padding
   each head (as the Pallas kernels pad to 128); what padding cannot reach
   (a larger head dim, a dtype or group the kernel does not take, a Swin
   block width the LayerNorm does not take) raises on the card before any
   launch. No wrapper runs its plain version on the card.

On the CPU the padding is checked through the wrappers' padding functions:
the plain version on padded q/k/v with the true head dim's scale, sliced
back, equals the plain version on the unpadded operands (float32, 1e-6: the
zero channels add exact zeros, only the summation order can move). The
card's side is checked by letting the wrappers take the CPU tensors for
CUDA ones (their device test patched) with the kernel library replaced by
a stub that raises ``Launched``: a padded call reaches the library, an
unpaddable one raises before it.
"""

import pytest
import torch

from vgqa_tpu_torch.ops.kernels import flash_attention as fa
from vgqa_tpu_torch.ops.kernels import flash_train as ft
from vgqa_tpu_torch.ops.kernels import swin_block as sb
from vgqa_tpu_torch.ops.kernels import window_attention as wa
from vgqa_tpu_torch.ops.kernels.padding import pad_heads, pad_last, unpad_heads

ATOL = 1e-6


def _qkv(W, Lq, Lk, H, dh, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(W, Lq, H * dh, generator=g, dtype=dtype)
    k = torch.randn(W, Lk, H * dh, generator=g, dtype=dtype)
    v = torch.randn(W, Lk, H * dh, generator=g, dtype=dtype)
    return q, k, v


def test_pad_heads_round_trip():
    x = torch.arange(2 * 3 * 12, dtype=torch.float32).reshape(2, 3, 12)
    p = pad_heads(x, 4, 8)
    assert p.shape == (2, 3, 32)
    assert torch.equal(p.reshape(2, 3, 4, 8)[..., :3], x.reshape(2, 3, 4, 3))
    assert not p.reshape(2, 3, 4, 8)[..., 3:].any()
    assert torch.equal(unpad_heads(p, 4, 3), x)
    assert pad_heads(x, 4, 3) is x and unpad_heads(x, 4, 3) is x
    assert pad_last(x, 12) is x and pad_last(x, 16).shape == (2, 3, 16)
    with pytest.raises(ValueError):
        pad_heads(x, 2, 4)


@pytest.mark.parametrize("dh", [4, 8, 16])
def test_window_attention_padded_equals_plain(dh):
    H, W, N = 4, 6, 19
    q, k, v = _qkv(W, N, N, H, dh)
    kv = (torch.rand(2, N, generator=torch.Generator().manual_seed(1)) > 0.3).float()
    kv[:, 0] = 1
    bias = torch.randn(H, N, N)
    want = wa.window_attention_reference(q, k, v, bias=bias, key_valid=kv, num_heads=H)
    got = unpad_heads(wa.window_attention_reference(
        *(pad_heads(t, H, wa.HEAD_DIM) for t in (q, k, v)), bias=bias, key_valid=kv,
        num_heads=H, scale=dh ** -0.5), H, dh)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dh,rate", [(8, 0.0), (16, 0.1)])
def test_flash_train_padded_equals_plain(dh, rate):
    """Forward and gradients; the keep mask is drawn per (row, query, key),
    so the padded call keeps the same elements."""
    H = 4
    q, k, v = (t.requires_grad_() for t in _qkv(3, 13, 17, H, dh, seed=2))
    mask = torch.ones(3, 17, dtype=torch.bool)
    mask[1, 11:] = False
    g = torch.randn(3, 13, H * dh, generator=torch.Generator().manual_seed(3))

    out = ft.flash_mha_train(q, k, v, H, key_mask=mask, dropout_rate=rate, seed=9)
    want = torch.autograd.grad(out, (q, k, v), g)
    qp, kp, vp = (pad_heads(t, H, ft.HEAD_DIM) for t in (q, k, v))
    outp = unpad_heads(ft.flash_mha_train(qp, kp, vp, H, key_mask=mask, dropout_rate=rate,
                                          seed=9, scale=dh ** -0.5), H, dh)
    got = torch.autograd.grad(outp, (q, k, v), g)
    torch.testing.assert_close(outp, out, atol=ATOL, rtol=0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dh", [8, 16, 32])
def test_flash_mha_padded_equals_plain(dh):
    H = 4
    q, k, v = _qkv(2, 21, 21, H, dh, seed=4)
    mask = torch.ones(2, 21, dtype=torch.bool)
    mask[0, 15:] = False
    want = fa.flash_mha_reference(q, k, v, H, mask)
    got = unpad_heads(fa.flash_mha_reference(*(pad_heads(t, H, fa.K4_HEAD_DIM)
                                               for t in (q, k, v)), H, mask,
                                             scale=dh ** -0.5), H, dh)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dh,group", [(16, 4), (64, 1)])
def test_flash_gqa_padded_equals_plain(dh, group):
    Hkv, S, Lq = 2, 40, 9
    g = torch.Generator().manual_seed(5)
    q = torch.randn(Hkv * group, Lq, dh, generator=g)
    k, v = torch.randn(Hkv, S, dh, generator=g), torch.randn(Hkv, S, dh, generator=g)
    want = fa.flash_gqa_causal_reference(q, k, v, 20, 27)
    got = fa.flash_gqa_causal_reference(*(pad_last(t, fa.K5_HEAD_DIM) for t in (q, k, v)),
                                        20, 27, scale=dh ** -0.5)[..., :dh]
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_swin_chain_widths():
    """The chain takes Swin-T/S/B (head dim 32) and the tiny test Swin's last
    two stages (C 32 in heads of 16, padded; C 64 in heads of 32); its first
    two (C 8, 16) are not LayerNorm widths of the chain, and raise on the
    card."""
    from vgqa_tpu_torch.models.video_swin import VIDEO_SWIN_CONFIGS

    def stages(name):
        c = VIDEO_SWIN_CONFIGS[name]
        return [sb.chain_takes(c.embed_dim * 2 ** i, h) for i, h in enumerate(c.num_heads)]

    assert stages("video_swin_t_p4w7") == stages("video_swin_b_p4w7") == [True] * 4
    assert stages("video_swin_test") == [False, False, True, True]
    assert not sb.chain_takes(96, 2)        # head dim 48


# ---- the card's side: padded calls launch, the rest raise first ----------

class Launched(Exception):
    """The stub kernel library was reached: the call went to a launch."""


@pytest.fixture
def as_card(monkeypatch):
    """The wrappers take these CPU tensors for CUDA ones; the kernel library
    is a stub that raises :class:`Launched`."""
    monkeypatch.setattr(wa, "_device_of", lambda q: "cuda")
    monkeypatch.setattr(ft, "_device_of", lambda q: "cuda")
    monkeypatch.setattr(fa, "_device_of", lambda q, what: "cuda")

    class Card:
        type = "cuda"

    real = sb._takes_kernel

    def takes(name, x, C, heads):
        fake = type("T", (), {"device": Card, "dtype": x.dtype})
        return real(name, fake, C, heads)

    monkeypatch.setattr(sb, "_takes_kernel", takes)

    def stub_library():
        raise Launched

    monkeypatch.setattr("vgqa_tpu_torch.ops.kernels.build.load_library", stub_library)


@pytest.mark.parametrize("dh,reaches", [(8, True), (16, True), (64, False)])
def test_window_attention_routes_large_head_dims(as_card, dh, reaches):
    q, k, v = _qkv(2, 7, 7, 2, dh)
    with pytest.raises(Launched if reaches else ValueError):
        wa.window_attention(q, k, v, num_heads=2)


def test_window_attention_rejects_too_many_tokens(as_card):
    q, k, v = _qkv(1, wa.MAX_TOKENS + 1, wa.MAX_TOKENS + 1, 1, 32)
    with pytest.raises(ValueError, match="tokens"):
        wa.window_attention(q, k, v, num_heads=1)


@pytest.mark.parametrize("dh,reaches", [(8, True), (48, False)])
def test_flash_train_routes_large_head_dims(as_card, dh, reaches):
    q, k, v = _qkv(2, 7, 9, 2, dh)
    with pytest.raises(Launched if reaches else ValueError):
        ft.flash_mha_train(q, k, v, 2, dropout_rate=0.1, seed=3)


@pytest.mark.parametrize("case", ["float32", "head_dim_128", "head_dim_16"])
def test_flash_mha_routes_what_it_does_not_take(as_card, case):
    dtype, dh = {"float32": (torch.float32, 16), "head_dim_128": (torch.bfloat16, 128),
                 "head_dim_16": (torch.bfloat16, 16)}[case]
    q, k, v = _qkv(2, 5, 5, 2, dh, dtype=dtype)
    want = {"float32": TypeError, "head_dim_128": ValueError, "head_dim_16": Launched}[case]
    with pytest.raises(want):
        fa.flash_mha(q, k, v, 2)


@pytest.mark.parametrize("case", ["float32", "group_3", "head_dim_16"])
def test_flash_gqa_routes_what_it_does_not_take(as_card, case):
    H, dtype = {"float32": (4, torch.float32), "group_3": (6, torch.bfloat16),
                "head_dim_16": (4, torch.bfloat16)}[case]
    g = torch.Generator().manual_seed(0)
    q = torch.randn(H, 5, 16, generator=g).to(dtype)
    k = torch.randn(2, 12, 16, generator=g).to(dtype)
    want = {"float32": TypeError, "group_3": ValueError, "head_dim_16": Launched}[case]
    with pytest.raises(want):
        fa.flash_gqa_causal(q, k, k, 3, 8)


@pytest.mark.parametrize("fused", [False, True])
def test_swin_block_routes_the_tiny_widths(as_card, fused):
    """The tiny test Swin's C = 16 in heads of 8 raises before a launch."""
    C, heads, window = 16, 2, (2, 2, 2)
    g = torch.Generator().manual_seed(0)
    w = [1 + 0.1 * torch.randn(C, generator=g), 0.1 * torch.randn(C, generator=g),
         0.2 * torch.randn(C, 3 * C, generator=g), 0.1 * torch.randn(3 * C, generator=g),
         0.2 * torch.randn(C, C, generator=g), 0.1 * torch.randn(C, generator=g),
         1 + 0.1 * torch.randn(C, generator=g), 0.1 * torch.randn(C, generator=g),
         0.2 * torch.randn(C, 4 * C, generator=g), 0.1 * torch.randn(4 * C, generator=g),
         0.1 * torch.randn(4 * C, C, generator=g), 0.1 * torch.randn(C, generator=g)]
    bias = 0.1 * torch.randn(heads, 8, 8, generator=g)
    with pytest.raises(ValueError, match="layernorm"):
        if fused:
            sb.swin_block_fused(torch.randn(4, 8, C, generator=g), *w, bias, heads)
        else:
            sb.swin_block_canvas(torch.randn(1, 2, 4, 4, C, generator=g), *w, bias, heads,
                                 window, (1, 1, 1))


# ---- the float32 policy ----------------------------------------------------

def _tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def _tiny_cfg():
    from vgqa_tpu_torch.config import build_default_cfg

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
    return cfg


@pytest.mark.parametrize("entry", ["policy", "load_model", "trainer"])
def test_entry_points_set_the_float32_policy(entry):
    from vgqa_tpu_torch.inference.grounding import load_model
    from vgqa_tpu_torch.training.trainer import Trainer
    from vgqa_tpu_torch.utils.device import apply_precision_policy

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    _tf32(True)
    try:
        if entry == "policy":
            apply_precision_policy()
        elif entry == "load_model":
            load_model(_tiny_cfg(), device="cpu")
        else:
            Trainer(_tiny_cfg(), device="cpu").setup(max_iter=1)
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
