"""The trace reduction on a synthetic Chrome trace: the union of device
intervals, kernels attributed through their launches to the pb.* spans,
and idle gaps named by the host op open at their start."""

from __future__ import annotations

import pytest

from portbench import trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid, "args": args}


def synthetic():
    ev = [
        _x("user_annotation", "pb.decode", 0, 100),
        _x("user_annotation", "pb.matmul", 10, 20),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 2, correlation=1),
        _x("user_annotation", "pb.attn", 40, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 42, 2, correlation=2),
        _x("cuda_runtime", "cudaLaunchKernel", 60, 2, correlation=3),
        _x("cpu_op", "aten::item", 120, 60),
        _x("user_annotation", "pb.prefill", 200, 50),
        _x("user_annotation", "pb.matmul", 205, 40),
        _x("cuda_runtime", "cudaLaunchKernel", 210, 2, correlation=4),
        # device: two streams overlapping in [30, 40)
        _x("kernel", "k1", 20, 20, tid=7, correlation=1),
        _x("kernel", "k2", 30, 30, tid=8, correlation=2),
        _x("gpu_memcpy", "copy", 70, 10, tid=7, correlation=3),
        _x("kernel", "k1", 220, 30, tid=7, correlation=4),
    ]
    return {"traceEvents": ev}


def test_union_and_window():
    s = trace.summarize(synthetic())
    assert s.window_s == pytest.approx(250e-6)
    # [20, 60) + [70, 80) + [220, 250)
    assert s.busy_s == pytest.approx(80e-6)
    assert dict(s.device_ops)["k1"] == pytest.approx(50e-6)


def test_attribution_by_launch():
    s = trace.summarize(synthetic())
    assert s.device_s["decode", "matmul"] == pytest.approx(20e-6)
    assert s.device_s["decode", "attn"] == pytest.approx(30e-6)
    assert s.device_s["decode", "all"] == pytest.approx(60e-6)
    assert s.device_s["prefill", "matmul"] == pytest.approx(30e-6)


def test_idle_gaps_named_by_host():
    gaps = dict(trace.summarize(synthetic()).idle_gaps)
    # idle [0, 20), [60, 70), [80, 220), each piece under the innermost
    # host event open over it
    want = {"pb.decode": 38e-6, "pb.matmul": 21e-6, "cudaLaunchKernel": 6e-6,
            "aten::item": 60e-6, "pb.prefill": 5e-6,
            "(host outside any traced op)": 40e-6}
    assert gaps.keys() == want.keys()
    for k, v in want.items():
        assert gaps[k] == pytest.approx(v), k


def test_union_of_intervals():
    total, merged = trace.union_s([(0, 2), (1, 3), (5, 6), (6, 7)])
    assert total == 5 and merged == [[0, 3], [5, 7]]
