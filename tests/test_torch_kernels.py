"""The port's kernels (vgqa_tpu_torch.ops.kernels) against the Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; here that version is
held against the Pallas kernel in interpret mode on the cases of
tests/test_pallas_window.py. The hand-written kernels themselves are tested
on the card by tests/test_torch_kernels_cuda.py.

Tolerances (float32 on both sides):
* window_attention: atol 1e-4 — both compute the same f32 softmax; only the
  summation order differs (~1e-6 observed).
* swin_block_canvas: atol 1e-3 — the TPU kernel evaluates GELU through an
  erf polynomial (abs err 8.7e-5), skips the softmax max-subtraction and
  takes LayerNorm statistics as E[x^2] - mu^2; the port uses erf, the max
  and two-pass statistics.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vgqa_tpu.models import video_swin as jvs
from vgqa_tpu.ops.pallas.swin_block import swin_block_canvas as pallas_swin_block
from vgqa_tpu.ops.pallas.window_attention import window_attention as pallas_window_attention
from vgqa_tpu_torch.models import video_swin as tvs
from vgqa_tpu_torch.ops.kernels.swin_block import swin_block_canvas
from vgqa_tpu_torch.ops.kernels.window_attention import window_attention

WA_ATOL = 1e-4
SWIN_ATOL = 1e-3


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


# (W, N, heads, head_dim, bias, region rows, key_valid, scale) — the cases of
# test_pallas_window.py's window_attention tests
WA_CASES = {
    "no_mask": (3, 24, 2, 16, True, None, False, 1.0),
    "region_ids": (4, 18, 3, 8, True, 2, False, 1.0),
    "swin_shapes": (2, 392, 3, 32, True, None, False, 0.1),
    "key_valid_no_bias": (4, 16, 2, 8, False, None, True, 1.0),
    "encoder_row": (6, 30, 2, 32, False, None, True, 1.0),
}


@pytest.mark.parametrize("case", sorted(WA_CASES))
def test_window_attention_matches_pallas(case):
    W, N, H, D, has_bias, region_rows, has_kv, sc = WA_CASES[case]
    rng = np.random.RandomState(sorted(WA_CASES).index(case))
    q, k, v = (rng.randn(W, N, H * D).astype(np.float32) * sc for _ in range(3))
    bias = rng.randn(H, N, N).astype(np.float32) * sc if has_bias else None
    region = (rng.randint(0, 3, (region_rows, N)).astype(np.int32)
              if region_rows else None)
    kv = None
    if has_kv:
        kv = (rng.rand(W, N) > 0.3).astype(np.float32)
        kv[:, 0] = 1.0
    ref = pallas_window_attention(_j(q), _j(k), _j(v), _j(bias), region=_j(region),
                                  key_valid=_j(kv), num_heads=H, interpret=True)
    out = window_attention(_t(q), _t(k), _t(v), _t(bias), _t(region), _t(kv),
                           num_heads=H)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=WA_ATOL)


def _block_weights(rng, C):
    def r(*s, sc=0.2):
        return (rng.randn(*s) * sc).astype(np.float32)

    return [1 + r(C), r(C), r(C, 3 * C, sc=C ** -0.5), r(3 * C),
            r(C, C, sc=C ** -0.5), r(C), 1 + r(C), r(C),
            r(C, 4 * C, sc=C ** -0.5), r(4 * C), r(4 * C, C, sc=(4 * C) ** -0.5), r(C)]


# (dims D, H, W, C, heads, window, shift, batch, gates) — the canvas geometry
# of test_pallas_window.py's block/backbone cases: plain and shifted windows,
# window padding (valid), the row-batched grid, and DropPath gates
SWIN_CASES = {
    "plain": ((4, 6, 6), 8, 2, (2, 2, 2), (0, 0, 0), 1, None),
    "shifted": ((4, 6, 6), 8, 2, (2, 2, 2), (1, 1, 1), 1, None),
    "padded": ((3, 5, 7), 8, 2, (2, 2, 2), (0, 0, 0), 1, None),
    "padded_shifted": ((3, 5, 7), 8, 2, (2, 2, 2), (1, 1, 1), 1, None),
    "row_batched": ((4, 8, 4), 16, 2, (2, 2, 2), (1, 1, 1), 1, None),
    "swin_window": ((8, 7, 14), 64, 2, (8, 7, 7), (4, 3, 3), 1, None),
    "gates": ((3, 5, 6), 8, 2, (2, 2, 2), (1, 1, 1), 2, [[1.0, 0.0], [1.25, 2.0]]),
}


@pytest.mark.parametrize("case", sorted(SWIN_CASES))
def test_swin_block_canvas_matches_pallas(case):
    dims, C, heads, full_window, full_shift, B, gates = SWIN_CASES[case]
    rng = np.random.RandomState(10 + sorted(SWIN_CASES).index(case))
    window, shift = jvs._adjust_window(dims, full_window, full_shift)
    assert (window, shift) == tvs._adjust_window(dims, full_window, full_shift)
    padded = tuple(d + (-d) % w for d, w in zip(dims, window))
    N = window[0] * window[1] * window[2]
    canvas = rng.randn(B, *padded, C).astype(np.float32)
    ws = _block_weights(rng, C)
    bias = (rng.randn(heads, N, N) * 0.2).astype(np.float32)
    region = valid = None
    if any(shift):
        region = tvs._region_partition(padded, window, shift)
        np.testing.assert_array_equal(
            region, np.asarray(jvs._region_partition(padded, window, shift)))
    valid = tvs._valid_partition(dims, padded, window, shift)
    j_valid = jvs._valid_partition(dims, padded, window, shift)
    assert (valid is None) == (j_valid is None)
    if valid is not None:
        np.testing.assert_array_equal(valid, np.asarray(j_valid))
    gates = None if gates is None else np.asarray(gates, np.float32)

    ref = pallas_swin_block(_j(canvas), *map(_j, ws), _j(bias), heads, window, shift,
                            region=_j(region), valid=_j(valid), gates=_j(gates),
                            interpret=True)
    out = swin_block_canvas(_t(canvas), *map(_t, ws), _t(bias), heads, window, shift,
                            region=_t(region), valid=_t(valid), gates=_t(gates))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=SWIN_ATOL)


def test_relative_position_index_matches_jax():
    for window in ((2, 2, 2), (8, 7, 7), (3, 2, 4)):
        np.testing.assert_array_equal(
            tvs._relative_position_index(window).numpy(),
            np.asarray(jvs._relative_position_index(window)))


def test_kernel_wrappers_reject_other_devices():
    q = torch.zeros(1, 4, 32, device="meta")
    with pytest.raises(RuntimeError):
        window_attention(q, q, q, num_heads=1)
