"""K3 (flash_mha_train) on the CPU: the port's plain version against the
Pallas kernel of vgqa_tpu in interpret mode (rate 0: forward and the grads
of q, k, v), and against a dense explicit-mask oracle built from the
port's own keep function (rate 0.1: forward and grads).

Tolerances: float32 atol 1e-5 (the same f32 formulas in another summation
order); bfloat16 atol 3e-2 on outputs of magnitude ~1 (both sides round
the probabilities and the outputs to bf16, one bf16 ulp at 1 is 7.8e-3,
and the rounding points of the two frameworks' matmuls differ).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgqa_tpu.ops.pallas.flash_train import flash_mha_train as jflash
from vgqa_tpu_torch.ops.kernels.flash_train import (
    flash_mha_train,
    flash_train_bwd,
    flash_train_bwd_reference,
    flash_train_fwd,
    fold_heads,
    keep_mask,
    keep_threshold,
    pack_keep_bits,
    philox4x32,
    supported_seq,
    unpack_keep_bits,
)

HEADS, DH = 2, 32
TOL = {"float32": 1e-5, "bfloat16": 3e-2}


def _inputs(Lq, Lk, seed=0, lead=(2,)):
    rng = np.random.RandomState(seed)
    q = rng.randn(*lead, Lq, HEADS * DH).astype(np.float32)
    k = rng.randn(*lead, Lk, HEADS * DH).astype(np.float32)
    v = rng.randn(*lead, Lk, HEADS * DH).astype(np.float32)
    mask = rng.rand(*lead, Lk) > 0.25
    mask[..., 0] = True
    mask[..., -5:] = False            # padded keys at the ragged end
    cot = rng.randn(*lead, Lq, HEADS * DH).astype(np.float32)
    return q, k, v, mask, cot


def _port(q, k, v, mask, cot, dtype, rate=0.0, seed=0):
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v))
    out = flash_mha_train(qt, kt, vt, HEADS, key_mask=torch.from_numpy(mask),
                          dropout_rate=rate, seed=seed)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return [t.detach().float().numpy() for t in (out, qt.grad, kt.grad, vt.grad)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Lq,Lk", [(124, 124), (418, 418), (70, 130)])
def test_plain_matches_pallas_interpret(Lq, Lk, dtype):
    q, k, v, mask, cot = _inputs(Lq, Lk)
    jdt = jnp.dtype(dtype)

    def jloss(q, k, v):
        o = jflash(q, k, v, HEADS, key_mask=jnp.asarray(mask), interpret=True)
        return (o.astype(jnp.float32) * cot).sum(), o

    (_, out_j), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    got = _port(q, k, v, mask, cot, getattr(torch, dtype))
    want = [np.asarray(a, np.float32) for a in (out_j, *grads_j)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=TOL[dtype], err_msg=name)


def _dense_oracle(q, k, v, mask, keep, rate):
    """Plain attention with an explicit keep mask, differentiated by autograd."""
    W, Lq, _ = q.shape

    def heads(x):
        return x.reshape(W, x.shape[1], HEADS, DH).transpose(1, 2)

    s = heads(q) @ heads(k).transpose(-1, -2) * DH ** -0.5
    s = s.masked_fill(~mask[:, None, None, :], -1e30)
    p = torch.softmax(s, -1)
    w = torch.where(keep.reshape(W, HEADS, Lq, -1), p, 0.0) / (1.0 - rate)
    return (w @ heads(v)).transpose(1, 2).reshape(W, Lq, HEADS * DH)


@pytest.mark.parametrize("Lq,Lk", [(124, 124), (70, 130)])
def test_dropout_matches_explicit_mask_oracle(Lq, Lk):
    rate, seed = 0.1, 1234
    q, k, v, mask, cot = _inputs(Lq, Lk, seed=1, lead=(3,))
    got = _port(q, k, v, mask, cot, torch.float32, rate=rate, seed=seed)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    keep = keep_mask(seed, 3 * HEADS, Lq, Lk, rate)
    out = _dense_oracle(qt, kt, vt, torch.from_numpy(mask), keep, rate)
    (out * torch.from_numpy(cot)).sum().backward()
    want = [t.detach().numpy() for t in (out, qt.grad, kt.grad, vt.grad)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)
    # the same seed reproduces, another seed and rate 0 differ
    again = _port(q, k, v, mask, cot, torch.float32, rate=rate, seed=seed)
    other = _port(q, k, v, mask, cot, torch.float32, rate=rate, seed=seed + 1)
    plain = _port(q, k, v, mask, cot, torch.float32)
    for a, b in zip(got, again):
        np.testing.assert_array_equal(a, b)
    assert np.abs(got[0] - other[0]).max() > 1e-3
    assert np.abs(got[0] - plain[0]).max() > 1e-3


def test_keep_share_and_threshold():
    keep = keep_mask(seed=-7, rows=512, Lq=124, Lk=124, rate=0.1)
    assert abs(float(keep.float().mean()) - 0.9) < 0.01
    # rows, queries and keys all decorrelate
    assert not torch.equal(keep[0], keep[1])
    assert not torch.equal(keep[0, 0], keep[0, 1])
    assert keep_threshold(0.0) == 0 and keep_threshold(1.0) == 1 << 24
    assert keep_threshold(0.1) == 1677722      # ceil(f32(0.1) * 2^24)


@pytest.mark.parametrize("counter,key,words", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
])
def test_philox_known_answer(counter, key, words):
    """Philox4x32-10 against the Random123 known-answer vectors: all four
    output words."""
    got = philox4x32(counter, key)
    assert tuple(int(w) for w in got) == words


@pytest.mark.parametrize("Lk", [418, 130])
def test_keep_mask_four_keys_per_call(Lk):
    """Keys 4c .. 4c+3 of one (row, query) take words 0..3 of the one call
    with counter (query, c, 0, 0) and key (seed + row, 0); the last group of
    a ragged Lk keeps its first Lk % 4 words."""
    seed, rate, rows, Lq = 2024, 0.25, 3, 5
    keep = keep_mask(seed, rows, Lq, Lk, rate)
    thresh = keep_threshold(rate)
    for b in range(rows):
        for i in (0, Lq - 1):
            for c in (0, 1, (Lk - 1) // 4):
                words = philox4x32((i, c, 0, 0), (seed + b, 0))
                for e, w in enumerate(words):
                    if 4 * c + e < Lk:
                        assert bool(keep[b, i, 4 * c + e]) == ((int(w) >> 8) >= thresh)


@pytest.mark.parametrize("Lk", [124, 418, 130, 32])
def test_keep_bits_pack_round_trip(Lk):
    """The forward kernel's bit layout: bit j % 32 of word j // 32 is key j,
    zero past Lk; unpacking gives the mask back."""
    keep = keep_mask(seed=-3, rows=4, Lq=6, Lk=Lk, rate=0.3)
    bits = pack_keep_bits(keep)
    assert bits.dtype == torch.int32 and bits.shape == (4, 6, (Lk + 31) // 32)
    assert torch.equal(unpack_keep_bits(bits, Lk), keep)
    words = bits.to(torch.int64) & 0xFFFFFFFF
    last = (Lk - 1) // 32
    assert int(words[1, 2, last]) >> (Lk - 32 * last) == 0
    j = Lk - 1
    assert bool((int(words[3, 5, j // 32]) >> (j % 32)) & 1) == bool(keep[3, 5, j])


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_plain_wrappers_save_keep_bits(rate):
    """The CPU path runs the kernels' data flow: the forward returns the keep
    mask it drew as bits (None at rate 0), the backward reads them and equals
    the plain backward that draws the mask from the seed; bits that do not
    fit the call are refused."""
    seed, W, Lq, Lk = 99, 2, 70, 130
    q, k, v, mask, cot = (torch.from_numpy(a) for a in _inputs(Lq, Lk, seed=2))
    args = (mask, seed, rate, DH ** -0.5, HEADS)
    out, lse, bits = flash_train_fwd(q, k, v, *args)
    if rate == 0.0:
        assert bits is None
    else:
        assert torch.equal(bits, pack_keep_bits(keep_mask(seed, W * HEADS, Lq, Lk, rate)))
    grads = flash_train_bwd(q, k, v, out, cot, lse, bits, mask, rate, DH ** -0.5, HEADS)
    maskf = mask.repeat_interleave(HEADS, dim=0)
    want = flash_train_bwd_reference(*(fold_heads(t, HEADS) for t in (q, k, v, out, cot)),
                                     lse, maskf, seed, rate, DH ** -0.5)
    for a, b in zip(grads, want):
        torch.testing.assert_close(fold_heads(a, HEADS), b, atol=0, rtol=0)
    wrong = None if rate else torch.zeros(W * HEADS, Lq, 5, dtype=torch.int32)
    with pytest.raises(ValueError):
        flash_train_bwd(q, k, v, out, cot, lse, wrong, mask, rate, DH ** -0.5, HEADS)


def test_supported_seq_bounds():
    assert supported_seq(418, 418) and supported_seq(1024, 1024)
    assert not supported_seq(1025, 418)
