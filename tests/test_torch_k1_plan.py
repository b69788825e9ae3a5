"""Host code of K1's Hopper GEMM (csrc/gemm_sm90.cu), on the CPU.

* ``swin_block.gemm_plan``, the launch plan the wrapper passes to the kernel,
  for every linear layer of every Swin-T and Swin-B stage at 224 and 420 px
  and at the tiny widths the card tests use: the N tile divides N, shared
  memory fits an H100 block, W stays resident where it fits, the grid
  covers the N tiles. (The card tests hold these plans against the
  library's own tile table and shared-memory formula.)
* The 3xTF32 product the kernel computes for float32, emulated in torch
  from ``swin_block.tf32_split``: within 1e-5 of max |ref| of a float64
  product at K1's widths (K up to 3,072), and at least 10x closer than a
  single tf32 product of the same operands.
"""

import numpy as np
import pytest
import torch

from vgqa_tpu_torch.ops.kernels import swin_block as sb

# (stage width C, tokens of a V = 2 forward at 224 px, of a 64f@420 step):
# Video Swin-T (and -S), then -B
STAGES = [(96, 2 * 64 * 56 * 56, 64 * 112 * 112), (192, 2 * 64 * 28 * 28, 64 * 56 * 56),
          (384, 2 * 64 * 14 * 14, 64 * 28 * 28), (768, 2 * 64 * 7 * 7, 64 * 14 * 14),
          # Video Swin-B
          (128, 2 * 64 * 56 * 56, 64 * 112 * 112), (256, 2 * 64 * 28 * 28, 64 * 56 * 56),
          (512, 2 * 64 * 14 * 14, 64 * 28 * 28), (1024, 2 * 64 * 7 * 7, 64 * 14 * 14)]
TINY = [(32, 2 * 16 * 14 * 14), (64, 2 * 16 * 7 * 7), (96, 2 * 16 * 14 * 14)]
LAYERS = {"qkv": (3, 1), "proj": (1, 1), "fc1": (4, 1), "fc2": (1, 4)}


def _cases():
    for C, m224, m420 in STAGES:
        for layer in LAYERS:
            for M in (m224, m420):
                yield C, layer, M
    for C, M in TINY:
        for layer in LAYERS:
            yield C, layer, M


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("C,layer,M", list(_cases()))
def test_gemm_plan(C, layer, M, f32):
    n_mul, k_mul = LAYERS[layer]
    N, K = n_mul * C, k_mul * C
    p = sb.gemm_plan(M, N, K, f32)
    bke = 16 if f32 else 32
    assert p["bn"] in sb.GEMM_BNS and p["bn"] % p["wn"] == 0
    assert N % p["bn"] == 0 and p["n_tiles"] == N // p["bn"]          # exact N
    assert p["ksteps"] * bke == K                                     # no padded k-step
    assert p["smem"] == sb.gemm_smem_bytes(f32, p["bn"], p["stages"], p["kps"], p["resident"],
                                           p["ksteps"])
    assert p["smem"] <= (sb.GEMM_SMEM_MAX2 if p["bps"] == 2 else 227 * 1024)
    assert p["stages"] >= 2 and p["ksteps"] % p["kps"] == 0
    assert p["bps"] in (1, 2) and (p["bps"] == 1 or p["bn"] <= 96)
    if p["resident"]:
        assert p["stages"] >= 3
    assert p["m_tiles"] == -(-M // 128)
    assert p["grid"] % p["n_tiles"] == 0 and p["n_tiles"] <= p["grid"]
    assert p["grid"] // p["n_tiles"] <= p["m_tiles"]
    assert p["grid"] <= max(p["bps"] * sb.H100_SMS, p["n_tiles"])
    # W resident wherever a tile of at least min(96, N) columns fits beside
    # four A slots: every layer of widths up to 192 in bf16
    if not f32 and C <= 192:
        assert p["resident"]
    if p["resident"]:
        assert p["ksteps"] * p["bn"] * 64 * (2 if f32 else 1) < p["smem"]


def test_gemm_plan_exact_tiles_at_stage_0():
    """Stage 0 in bf16 (byte-bound): tiles of 96 columns, exact for qkv's
    288, proj's and fc2's 96 and fc1's 384, two blocks per SM; the
    product-bound stage 3 keeps one block per SM."""
    for N, K in ((288, 96), (96, 96), (384, 96), (96, 384)):
        p = sb.gemm_plan(401408, N, K, False)
        assert (p["bn"], p["bps"], N % p["bn"]) == (96, 2, 0)
    assert sb.gemm_plan(6272, 3072, 768, False)["bps"] == 1


@pytest.mark.parametrize("M,N,K,f32", [(0, 96, 96, False), (100, 100, 96, False),
                                       (100, 96, 40, False), (100, 96, 24, True)])
def test_gemm_plan_rejects(M, N, K, f32):
    with pytest.raises(ValueError):
        sb.gemm_plan(M, N, K, f32)


def test_tf32_split_bits():
    x = torch.tensor([1.0, -1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -12, -(1.0 + 2 ** -11), 3.14159265,
                      1e-30, float("inf"), 0.0])
    hi, lo = sb.tf32_split(x)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()               # low 13 bits zero
    finite = torch.isfinite(x)
    assert torch.equal((hi + lo)[finite], x[finite])                  # lo is exact
    assert hi[2].item() == 1.0 + 2 ** -10 and hi[4].item() == -(1.0 + 2 ** -10)  # ties away
    assert hi[3].item() == 1.0                                        # below half an ulp
    assert (lo[finite].abs() <= x[finite].abs() * 2 ** -11).all()


def _tf32_trunc(x):
    """What the tensor cores read of an f32 operand in tf32: its top 19 bits."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("K", [96, 384, 768, 3072])
def test_3xtf32_product_emulated(K):
    rng = np.random.RandomState(K)
    a = torch.from_numpy(rng.randn(64, K).astype(np.float32))
    w = torch.from_numpy((rng.randn(96, K) * K ** -0.5).astype(np.float32))
    ref = a.double() @ w.double().t()
    a_hi, a_lo = sb.tf32_split(a)
    w_hi, w_lo = sb.tf32_split(w)
    three = (a_hi.double() @ w_hi.double().t() + a_hi.double() @ _tf32_trunc(w_lo).double().t()
             + _tf32_trunc(a_lo).double() @ w_hi.double().t()).float()
    one = (_tf32_trunc(a).double() @ _tf32_trunc(w).double().t()).float()
    scale = ref.abs().max().item()
    err3 = (three.double() - ref).abs().max().item() / scale
    err1 = (one.double() - ref).abs().max().item() / scale
    assert err3 < 1e-5
    assert err3 * 10 < err1
