"""The plain versions of the QA kernels (K4 flash_mha, K5 flash_gqa_causal,
K6 int4_matmul) against the Pallas kernels of ``vgqa_tpu`` in interpret
mode, on the same numpy inputs; the port's copy of the int4 routing gate
against the JAX gate; and the int4 pack, bit for bit. float32 throughout,
so the tolerances are those of ``tests/test_pallas.py`` (sums in another
order); bf16 inputs where the kernels take bf16 on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgqa_tpu.ops.pallas.flash_attention import flash_attention, flash_gqa_causal, flash_mha
from vgqa_tpu.ops.pallas.int4_matmul import int4_matmul, int4_matmul_kernel_applicable
from vgqa_tpu.qa import quant as jquant
from vgqa_tpu_torch.ops.kernels import flash_attention as tfa
from vgqa_tpu_torch.ops.kernels import int4_matmul as ti4
from vgqa_tpu_torch.qa import quant as tquant


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("B,Lq,Lk,D,p_mask,atol", [
    (2, 16, 24, 32, None, 2e-5),          # test_pallas.py basic
    (1, 8, 20, 16, 0.4, 2e-5),            # key mask
    (1, 130, 137, 48, "tail", 3e-5),      # lengths off the block grid
])
def test_flash_mha_plain_matches_pallas(B, Lq, Lk, D, p_mask, atol):
    rng = np.random.RandomState(Lq)
    q, k, v = (rng.randn(B, L, D).astype(np.float32) for L in (Lq, Lk, Lk))
    if p_mask is None:
        mask = None
    elif p_mask == "tail":
        mask = np.ones((B, Lk), bool)
        mask[0, 100:] = False
    else:
        mask = rng.rand(B, Lk) > p_mask
    want = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           key_mask=None if mask is None else jnp.asarray(mask),
                           interpret=True)
    got = tfa.flash_mha(_t(q), _t(k), _t(v), 1,
                        key_mask=None if mask is None else _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol)


def test_flash_mha_plain_multihead_layout_matches_pallas():
    rng = np.random.RandomState(3)
    V, T, L, H, dh = 1, 3, 20, 4, 16
    q, k, v = (rng.randn(V, T, L, H * dh).astype(np.float32) for _ in range(3))
    mask = rng.rand(V, T, L) > 0.3
    want = flash_mha(*(jnp.asarray(a) for a in (q, k, v)), H, key_mask=jnp.asarray(mask),
                     interpret=True)
    got = tfa.flash_mha(_t(q), _t(k), _t(v), H, key_mask=_t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


def test_flash_mha_plain_bf16_matches_pallas():
    rng = np.random.RandomState(4)
    q, k, v = (rng.randn(1, 16, 32).astype(np.float32) for _ in range(3))
    want = flash_attention(*(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)),
                           interpret=True)
    got = tfa.flash_mha(*(_t(a).bfloat16() for a in (q, k, v)), 1)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=3e-2)


def test_flash_mha_fully_masked_row_averages_values():
    """The port's documented choice: a row with every key masked averages V
    over its Lk keys (the Pallas kernel also counts its zero padding)."""
    rng = np.random.RandomState(5)
    q, k, v = (_t(rng.randn(2, 12, 64).astype(np.float32)) for _ in range(3))
    mask = torch.ones(2, 12, dtype=torch.bool)
    mask[1] = False
    out = tfa.flash_mha(q, k, v, 2, key_mask=mask)
    torch.testing.assert_close(out[1], v[1].mean(0).expand(12, 64), atol=1e-5, rtol=1e-5)
    partial = tfa.flash_mha(q[:1], k[:1], v[:1], 2)
    torch.testing.assert_close(out[:1], partial, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("H,Hkv,dh,S,Lq,off,length", [
    (8, 2, 16, 96, 32, 40, 70),     # test_pallas.py: grouped heads, offset, length bound
    (8, 2, 16, 96, 32, 0, 96),      # first chunk of a prefill
    (4, 4, 32, 64, 64, 0, 23),      # padded query rows (length < Lq)
])
def test_flash_gqa_causal_plain_matches_pallas(H, Hkv, dh, S, Lq, off, length):
    rng = np.random.RandomState(off + length)
    q = rng.randn(H, Lq, dh).astype(np.float32)
    k, v = (rng.randn(Hkv, S, dh).astype(np.float32) for _ in range(2))
    want = flash_gqa_causal(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=off,
                            length=jnp.asarray(length), blk_q=16, blk_k=32, interpret=True)
    got = tfa.flash_gqa_causal(_t(q), _t(k), _t(v), off, torch.tensor(length))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=3e-5)


@pytest.mark.parametrize("m,k,n", [(1, 1024, 512), (3, 1024, 512), (9, 1024, 512),
                                   (15, 1024, 512), (64, 1024, 512), (2, 4096, 512),
                                   (1, 1024, 1536)])
def test_int4_matmul_plain_matches_pallas(m, k, n):
    rng = np.random.RandomState(m + k + n)
    w = rng.randn(k, n).astype(np.float32) * 0.1
    x = rng.randn(m, k).astype(np.float32)
    qp = jquant.quantize_kernel_int4(jnp.asarray(w))
    want = np.asarray(int4_matmul(jnp.asarray(x), qp["kernel_q4"], qp["scale4"],
                                  interpret=True))
    got = ti4.int4_matmul(_t(x), _t(qp["kernel_q4"]), _t(qp["scale4"]))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)


def test_int4_gate_equals_jax_gate():
    grid = [(m, k, n, n_g) for m in (1, 8, 64, 65, 1024)
            for k in (64, 256, 501, 512, 1024, 1536, 4096, 14336)
            for n in (64, 90, 512, 768, 1024, 1536, 4096, 14336)
            for n_g in (1, 2, 3, 4, 8, 12, 32, 112, k // 128 or 1)]
    for args in grid:
        assert ti4.int4_matmul_kernel_applicable(*args) == int4_matmul_kernel_applicable(*args), args
    for k, n in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)):
        assert ti4.int4_matmul_kernel_applicable(64, k, n, k // 128)
        assert not ti4.int4_matmul_kernel_applicable(1024, k, n, k // 128)


@pytest.mark.parametrize("k,n,group", [(256, 64, 128), (1024, 96, 128), (96, 40, 64)])
def test_int4_pack_bit_identical(k, n, group):
    w = np.random.RandomState(k).randn(k, n).astype(np.float32)
    want = jquant.quantize_kernel_int4(jnp.asarray(w), group_size=group)
    got = tquant.quantize_kernel_int4(_t(w), group_size=group)
    np.testing.assert_array_equal(got["kernel_q4"].numpy(), np.asarray(want["kernel_q4"]))
    np.testing.assert_array_equal(got["scale4"].numpy(), np.asarray(want["scale4"]))
    deq = tquant.dequantize_kernel_int4(got)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jquant.dequantize_kernel_int4(want)))


@pytest.mark.parametrize("m", [1, 16])
def test_quant_matmul_int4_routes_match_jax(monkeypatch, m):
    """quant_matmul_int4 with the kernel route (interpret / plain version)
    and with the half-matmul form, both packages."""
    rng = np.random.RandomState(m)
    w = rng.randn(1024, 512).astype(np.float32) * 0.1
    x = rng.randn(m, 1024).astype(np.float32)
    qp = jquant.quantize_kernel_int4(jnp.asarray(w))
    tqp = {n: _t(a) for n, a in qp.items()}
    for interp, on in (("1", True), ("0", False)):
        monkeypatch.setenv("VGQA_PALLAS_INTERPRET", interp)
        want = np.asarray(jquant.quant_matmul_int4(jnp.asarray(x), qp))
        got = tquant.quant_matmul_int4(_t(x), tqp, kernels=on).numpy()
        np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
