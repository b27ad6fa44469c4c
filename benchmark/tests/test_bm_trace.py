"""Reading a profiler trace, on a small synthetic chrome trace."""

import json

import pytest

from benchmark import trace


def _x(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 1, "tid": tid}


EVENTS = [
    _x("benchmark.profiled", "user_annotation", 100, 1000),
    _x("aten::conv", "cpu_op", 100, 100),
    _x("cudaLaunchKernel", "cuda_runtime", 110, 5),
    _x("conv_wgmma<3, 64>", "kernel", 120, 200),
    _x("elementwise_kernel", "kernel", 300, 100),       # overlaps the conv
    _x("aten::equal", "cpu_op", 450, 150),
    _x("cudaStreamSynchronize", "cuda_runtime", 460, 120),
    _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 600, 50),
    _x("aten::copy_", "cpu_op", 640, 300),
    _x("aten::item", "cpu_op", 700, 100),
    _x("cudaMemcpyAsync", "cuda_runtime", 705, 10),
    _x("conv_wgmma<1, 128>", "kernel", 950, 300),       # runs past the span
    _x("late kernel", "kernel", 2000, 10),              # outside the span
    {"ph": "i", "name": "instant", "ts": 500},
]


def test_summary_of_a_synthetic_trace(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": EVENTS}))
    s = trace.summarize(trace.load_events(str(p)), "benchmark.profiled")
    assert s.span_s == pytest.approx(1000e-6)
    # busy: [120, 400] + [600, 650] + [950, 1100] = 280 + 50 + 150
    assert s.busy_s == pytest.approx(480e-6)
    assert s.syncs == 1
    assert s.device_s(("conv_wgmma",)) == pytest.approx(350e-6)
    assert s.device_s_by_name["elementwise_kernel"] == pytest.approx(100e-6)
    assert "late kernel" not in s.device_s_by_name
    # idle: [100, 120] in aten::conv's launch window -> the innermost
    # running op at 110 is cudaLaunchKernel; [400, 600] at 500:
    # cudaStreamSynchronize; [650, 950] at 800: aten::copy_
    assert s.idle_by_host_op == pytest.approx(
        {"cudaLaunchKernel": 20e-6, "cudaStreamSynchronize": 200e-6,
         "aten::copy_": 300e-6})
    top = s.top(s.idle_by_host_op, 2)
    assert [t[0] for t in top] == ["aten::copy_", "cudaStreamSynchronize"]


def test_union_merges_overlaps():
    assert trace.union([(5, 7), (1, 3), (2, 4), (7, 8)]) == [(1, 4), (5, 8)]
