"""The QA path's int8 and int4 GEMMs at bf16, against ``vgqa_tpu`` on the
same numpy inputs: both packages accumulate in f32 and round to bf16 once,
so at least 99.9% of the elements are bit-equal and the rest lie within
one bf16 ulp (the f32 sums run in another order). Also the K6 launch plan
(``ops/kernels/int4_matmul._plan``), which is pure Python."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgqa_tpu.ops.pallas.int4_matmul import int4_matmul
from vgqa_tpu.qa import quant as jquant
from vgqa_tpu_torch.ops.kernels import int4_matmul as ti4
from vgqa_tpu_torch.qa import quant as tquant


def _bf16_pair(seed, m, k, n, wscale=0.05):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).bfloat16()
    w = rng.randn(k, n).astype(np.float32) * wscale
    return x, w


def _jx(x_bf16):
    return jnp.asarray(x_bf16.float().numpy()).astype(jnp.bfloat16)


def _ordered(bits):
    """bf16 bit patterns -> integers in the order of the values."""
    b = bits.astype(np.int32)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def _assert_rounded_alike(got: torch.Tensor, want):
    """>= 99.9% bit-equal, the rest within one bf16 ulp."""
    assert got.dtype == torch.bfloat16
    g = got.contiguous().view(torch.int16).numpy().view(np.uint16)
    w = torch.from_numpy(np.asarray(want.astype(jnp.float32))).bfloat16()
    w = w.contiguous().view(torch.int16).numpy().view(np.uint16)
    assert g.shape == w.shape
    equal = float((g == w).mean())
    ulps = np.abs(_ordered(g) - _ordered(w)).max()
    assert equal >= 0.999, f"only {100 * equal:.3f}% bit-equal"
    assert ulps <= 1, f"{ulps} ulp apart"


@pytest.mark.parametrize("m,k,n", [(16, 1024, 512), (5, 512, 384)])
def test_quant_matmul_bf16_matches_jax(m, k, n):
    x, w = _bf16_pair(m + k + n, m, k, n)
    qp = jquant.quantize_llm_params({"q_proj": {"kernel": jnp.asarray(w)}})["q_proj"]
    want = jquant.quant_matmul(_jx(x), qp)
    tqp = {name: torch.from_numpy(np.array(a)) for name, a in qp.items()}
    _assert_rounded_alike(tquant.quant_matmul(x, tqp), want)


@pytest.mark.parametrize("m,k,n", [(128, 1024, 512), (72, 512, 256)])
def test_quant_matmul_int4_half_form_bf16_matches_jax(monkeypatch, m, k, n):
    """M > 64: the gate sends the product to the half-matmul form in both
    packages."""
    monkeypatch.setenv("VGQA_PALLAS_INTERPRET", "0")
    x, w = _bf16_pair(m + k + n, m, k, n)
    qp = jquant.quantize_kernel_int4(jnp.asarray(w))
    n_g = qp["scale4"].shape[0]
    assert not ti4.int4_matmul_kernel_applicable(m, k, n, n_g)
    want = jquant.quant_matmul_int4(_jx(x), qp)
    tqp = {name: torch.from_numpy(np.array(a)) for name, a in qp.items()}
    _assert_rounded_alike(tquant.quant_matmul_int4(x, tqp), want)


@pytest.mark.parametrize("group", [128, 8])
@pytest.mark.parametrize("m", [1, 2])
def test_int4_matmul_plain_bf16_matches_pallas(m, group):
    k, n = 1024, 512
    x, w = _bf16_pair(m, m, k, n, wscale=0.1)
    qp = jquant.quantize_kernel_int4(jnp.asarray(w), group)
    assert qp["scale4"].shape[0] == k // group
    want = int4_matmul(_jx(x), qp["kernel_q4"], qp["scale4"], interpret=True)
    got = ti4.int4_matmul(x, torch.from_numpy(np.array(qp["kernel_q4"])),
                          torch.from_numpy(np.array(qp["scale4"])))
    _assert_rounded_alike(got, want)


PROJ = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]
SMALL_GROUPS = [(1024, 512, 8), (1024, 512, 1), (96, 64, 24), (96, 64, 3), (1024, 90, 128)]


@pytest.mark.parametrize("k,n,g", [(k, n, 128) for k, n in PROJ] + SMALL_GROUPS)
@pytest.mark.parametrize("m", [1, 2, 8, 64])
def test_int4_plan_covers_each_packed_row_once(m, k, n, g):
    """Every shape and group size the gate admits has a plan (the wrapper's
    shape check passes): block (strip, chunk), warp w contracts low-half
    groups [(chunk * wk + w) * kg, + kg) over columns [strip * 16 nt,
    + 16 nt), so every (packed row, column) is covered exactly once, the
    fragments fit, and a strip's chunks form one cluster of at most 8
    blocks; at the projection shapes the grid fills the card's 132 SMs."""
    n_g = k // g
    assert ti4.int4_matmul_kernel_applicable(m, k, n, n_g)
    p = ti4._checked_plan(m, k, k // 2, n, n_g, n)
    n2 = n_g // 2
    assert p.nt in (1, 2, 4) and p.nt * p.mt <= 8 and 8 * p.mt >= m
    assert p.wk in (1, 2, 4) and n2 % (p.wk * p.kg) == 0
    assert p.chunks == n2 // (p.wk * p.kg) and 1 <= p.chunks <= 8
    cw = 16 * p.nt
    assert p.strips == -(-n // cw) and (p.strips - 1) * cw < n <= p.strips * cw
    rows = np.zeros(k // 2, np.int64)
    for chunk in range(p.chunks):
        for w in range(p.wk):
            r0 = (chunk * p.wk + w) * p.kg * g
            rows[r0:r0 + p.kg * g] += 1
    assert (rows == 1).all()
    if (k, n) in PROJ:
        assert p.strips * p.chunks >= 128
