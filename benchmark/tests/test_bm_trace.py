"""Reading a profiler trace, on a small synthetic chrome trace, with and
without the program's spans in it."""

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
# the same with the program's spans around its ops, and the device-side
# copy of a span, which is no device work
WITH_SPANS = EVENTS + [
    _x("ayq", "user_annotation", 100, 900),
    _x("ayq.forward", "user_annotation", 100, 350),
    _x("ayq.forward.conv.Conv_P1", "user_annotation", 100, 90),
    _x("ayq.nms", "user_annotation", 450, 500),
    _x("ayq.nms.sweep", "user_annotation", 450, 160),
    _x("ayq.forward", "gpu_user_annotation", 120, 280, tid=7)]


@pytest.mark.parametrize("events", (EVENTS, WITH_SPANS),
                         ids=("plain", "with_spans"))
def test_summary_of_a_synthetic_trace(tmp_path, events):
    """Every reading but the spans' is the same with spans in the trace."""
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": events}))
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


OLD_FIELDS = ("span_s", "busy_s", "device_s_by_name", "syncs",
              "idle_by_host_op")


@pytest.mark.parametrize("annotation", ("benchmark.profiled", None))
def test_spans_leave_every_trace_reading_as_it_was(annotation):
    """Each field the summary had before it carried the spans reads the
    same with spans in the trace, in the annotated window and without
    one."""
    before = trace.summarize(EVENTS, annotation)
    after = trace.summarize(WITH_SPANS, annotation)
    for field in OLD_FIELDS:
        assert getattr(after, field) == getattr(before, field), field
    assert before.device_s_by_span == {trace.OUTSIDE: before.device_s_by_name}


@pytest.mark.parametrize("annotation,lo,hi", (
    ("benchmark.profiled", 100, 1100), (None, 120, 2010)))
def test_summary_carries_the_spans_of_its_window(annotation, lo, hi):
    """The span fields are trace.attribute's over the window the other
    fields read: the annotation's, or the device events' without one."""
    s = trace.summarize(WITH_SPANS, annotation)
    assert s.span_s == pytest.approx((hi - lo) / 1e6)
    sp = trace.attribute(WITH_SPANS, lo, hi)
    for field, value in sp.items():
        assert getattr(s, field) == value, field
    # the item's sync is in no span, the stream sync in the sweep
    assert s.syncs_by_span == {"ayq.nms.sweep": 1}
    assert sum(sum(ops.values()) for ops in s.device_s_by_span.values()) \
        == pytest.approx(sum(s.device_s_by_name.values()))
    assert sum(s.idle_by_span.values()) == pytest.approx(s.span_s - s.busy_s)


def test_union_merges_overlaps():
    assert trace.union([(5, 7), (1, 3), (2, 4), (7, 8)]) == [(1, 4), (5, 8)]
