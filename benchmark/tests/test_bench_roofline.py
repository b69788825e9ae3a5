"""The yardstick reproduces the smoke run's kernel bounds (PERF.md, the
kernel table: K1 per 224 px V = 2 forward and per float32 64f@420 step, K2
at S = 124 / 418, K3 float32 at [512, 418, 32], K4 at [128, 1025, 64], K5
per chunk and per 8,698-token prefill), and K1 call by call against
``chip_smoke.k1_bound``."""

import pytest

import roofline as r


@pytest.mark.parametrize("got,want", [
    (lambda: r.k1_tower_bound_s(64, 224, 2), 1.367e-3),
    (lambda: r.k1_tower_bound_s(64, 420, 1, f32=True), 20.79e-3),
    (lambda: r.k2_bound_s(128, 124, 256), 0.0097e-3),
    (lambda: r.k2_bound_s(128, 418, 256), 0.0328e-3),
    (lambda: r.k3_f32_bound_s(64, 8, 418, 32), (0.171 + 0.427) * 1e-3),
    (lambda: r.k4_bound_s(8, 16, 1025, 64), 0.0348e-3),
    (lambda: r.k5_chunk_bound_s(0, 1024, 8698, 9216), 0.0087e-3),
    (lambda: r.k5_chunk_bound_s(8192, 1024, 8698, 9216), 0.1455e-3),
    (lambda: r.k5_prefill_bound_s(8698), 22.4e-3),
])
def test_documented_bounds(got, want):
    assert got() == pytest.approx(want, rel=3e-3)


def test_k1_calls_match_smoke_run():
    chip_smoke = pytest.importorskip("chip_smoke")
    mine = sorted((p, C, h, N) for p, C, h, N in r.swin_blocks(64, 420))
    theirs = []
    for dims, C, heads, shift, per_step in chip_smoke.K1_420_CASES:
        window, _ = r._adjust_window(dims, (8, 7, 7), shift)
        padded = tuple(d + (-d) % w for d, w in zip(dims, window))
        theirs += [(padded, C, heads, window[0] * window[1] * window[2])] * per_step
    assert mine == sorted(theirs)
    for padded, C, h, N in mine:
        assert r.k1_bound_s(2, padded, C, N, h) * 1e3 == pytest.approx(
            chip_smoke.k1_bound(2, padded, C, N, h)[0], rel=1e-12)
