"""K2 window_attention and K5 flash_gqa_causal at the ragged shapes their
Hopper kernels must handle: the port's plain versions (what each wrapper
runs for a CPU tensor) against the Pallas kernels in interpret mode.

The Hopper kernels cut these shapes into tiles of 64 (K2) or 128 (K5) rows
and keys: token counts just past a tile (17, 129, 130), under one (1, 16),
and the encoder's 418 (six full tiles and a tail of 34); for K5, chunk
offsets and lengths off the tile grid, a length at a tile boundary and
inside the chunk, query counts off the tile, and groups of 4 and 1 query
heads per KV head. tests/test_torch_kernels_cuda.py holds the kernels to the
same plain versions at the same cases on the card.

Tolerances (float32 on both sides, only the summation order differs):
atol 1e-4 for K2 and 3e-5 for K5, as tests/test_torch_kernels.py and
tests/test_torch_qa_kernels.py use.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgqa_tpu.ops.pallas.flash_attention import flash_gqa_causal as pallas_gqa
from vgqa_tpu.ops.pallas.window_attention import window_attention as pallas_window_attention
from vgqa_tpu_torch.ops.kernels.flash_attention import flash_gqa_causal
from vgqa_tpu_torch.ops.kernels.window_attention import window_attention

K2_ATOL = 1e-4
K5_ATOL = 3e-5
K2_HEADS, K2_DIM = 8, 32


@pytest.mark.parametrize("N", [1, 16, 17, 128, 129, 130, 418])
def test_window_attention_key_valid_ragged_matches_pallas(N):
    """The encoder form at 8 heads of 32: key_valid of 2 rows repeated over
    4 windows (row w reads w % 2), row 1's keys all masked (its windows
    average V over their N keys)."""
    rng = np.random.RandomState(N)
    W = 4
    q, k, v = (rng.randn(W, N, K2_HEADS * K2_DIM).astype(np.float32) for _ in range(3))
    kv = (rng.rand(2, N) > 0.3).astype(np.float32)
    kv[0, 0] = 1.0
    kv[1] = 0.0
    want = np.asarray(pallas_window_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), key_valid=jnp.asarray(kv),
        num_heads=K2_HEADS, interpret=True))
    got = window_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           key_valid=torch.from_numpy(kv), num_heads=K2_HEADS).numpy()
    np.testing.assert_allclose(got, want, atol=K2_ATOL)
    np.testing.assert_allclose(got[1::2], np.broadcast_to(v[1::2].mean(1, keepdims=True),
                                                          got[1::2].shape), atol=K2_ATOL)


def test_window_attention_maskless_ragged_matches_pallas():
    """The maskless form at a token count just past two tiles."""
    rng = np.random.RandomState(7)
    q, k, v = (rng.randn(2, 130, K2_HEADS * K2_DIM).astype(np.float32) for _ in range(3))
    want = np.asarray(pallas_window_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                              num_heads=K2_HEADS, interpret=True))
    got = window_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           num_heads=K2_HEADS).numpy()
    np.testing.assert_allclose(got, want, atol=K2_ATOL)


# (H, Hkv, Lq, S, q_offset, length), dh 128: offsets off the 64 / 128 grid
# (40, 200, 190), length below the chunk's end (100, 256) and on a tile
# boundary (128, 256, 384), Lq off the tile (70, 130), groups 4 and 1
K5_RAGGED = [
    (4, 1, 70, 300, 40, 300),
    (4, 4, 70, 300, 40, 100),
    (8, 2, 130, 400, 200, 256),
    (2, 2, 130, 400, 200, 384),
    (4, 1, 130, 300, 0, 128),
    (4, 4, 70, 300, 128, 300),
    (8, 2, 70, 260, 190, 260),
]


@pytest.mark.parametrize("H,Hkv,Lq,S,q_offset,length", K5_RAGGED)
def test_flash_gqa_causal_ragged_matches_pallas(H, Hkv, Lq, S, q_offset, length):
    rng = np.random.RandomState(H + Lq + q_offset + length)
    q = rng.randn(H, Lq, 128).astype(np.float32)
    k, v = (rng.randn(Hkv, S, 128).astype(np.float32) for _ in range(2))
    want = np.asarray(pallas_gqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 q_offset=q_offset, length=jnp.asarray(length),
                                 blk_q=64, blk_k=128, interpret=True))
    got = flash_gqa_causal(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           q_offset, torch.tensor(length)).numpy()
    np.testing.assert_allclose(got, want, atol=K5_ATOL)
