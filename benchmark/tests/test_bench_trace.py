"""The reduction of a profiler trace: the device's busy time is the union
of its operations, idle gaps are named by the innermost host operation or
harness span at their middle, and kernels are counted and timed by name."""

import pytest

from harness import reduce_trace


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduce_trace():
    events = [
        _x("kernel", "gemm_sm90_kernel<false, 96, 1, 2>", 0, 10),
        _x("kernel", "window_attn_sm90_kernel<1, true>", 5, 10),      # overlaps the first
        _x("gpu_memcpy", "Memcpy HtoD", 40, 10),
        _x("kernel", "window_attn_sm90_kernel<1, false>", 100, 20),
        _x("user_annotation", "serve.run_batch", 0, 200),
        _x("cpu_op", "aten::add", 20, 15),                             # covers gap 1's middle
        _x("cpu_op", "aten::copy_", 60, 5),                            # gap 2's middle is 75
    ]
    d = reduce_trace(events, 1.0)
    assert d.busy_s == (15 + 10 + 20) / 1e6
    assert d.n_kernels == 3 and d.kernel_count(r"window_attn_sm90_kernel<\d+, true>") == 1
    assert d.seconds_matching(r"gemm_sm90|, true>") == 20 / 1e6
    gaps = dict(d.idle_gaps)
    assert set(gaps) == {"aten::add", "serve.run_batch"}
    assert gaps["aten::add"] == pytest.approx(25 / 1e6)
    assert gaps["serve.run_batch"] == pytest.approx(50 / 1e6)
    assert d.device_ops[0] == ("window_attn_sm90_kernel<1, false>", 20 / 1e6)
