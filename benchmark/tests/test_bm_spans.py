"""The program's spans in a profiler trace (benchmark/spans.py): device time,
idle time and instances by span on a small synthetic chrome trace, the
stage readings and breakdown from the trace summary, the span metrics'
readers, and a traced CPU run broken down by them."""

from types import SimpleNamespace

import pytest

from benchmark import loops, spans, spec, trace
from benchmark.tests.test_bm_trace import _x

SEED = 2 ** 31 + 7


def _ann(name, ts, dur, tid=1):
    return _x(name, "user_annotation", ts, dur, tid)


def _launch(corr, ts, tid=1):
    return dict(_x("cudaLaunchKernel", "cuda_runtime", ts, 5, tid),
                args={"correlation": corr})


def _dev(name, ts, dur, corr, cat="kernel"):
    return dict(_x(name, cat, ts, dur, tid=7), args={"correlation": corr})


SPAN_EVENTS = [
    _ann("benchmark.profiled", 100, 1000),
    _ann("ayq.decode", 50, 45),                 # starts before the window
    _ann("ayq", 100, 890),
    _ann("ayq.quantize", 110, 90),
    _launch(1, 120), _dev("quant_k", 130, 50, 1),
    _ann("ayq.forward", 200, 400),
    _ann("ayq.forward.conv.L1", 210, 90),
    # runs on past its span's close: still the conv's
    _launch(2, 220), _dev("conv_wgmma<3>", 230, 170, 2),
    _ann("ayq.forward.concat", 300, 50),
    _launch(3, 310), _dev("cat_k", 400, 50, 3),
    _launch(4, 360), _dev("copy_k", 450, 10, 4),     # forward's own
    _ann("ayq.nms", 600, 350),
    _ann("ayq.nms.sweep", 610, 90),
    _launch(5, 620), _dev("gemv", 630, 20, 5),
    _x("cudaStreamSynchronize", "cuda_runtime", 660, 30),
    _ann("ayq.nms.sweep", 700, 100),
    _launch(6, 710), _dev("gemv", 720, 20, 6),
    _launch(7, 960), _dev("Memcpy DtoH", 960, 20, 7, "gpu_memcpy"),
    _launch(8, 1010), _dev("late_k", 1020, 30, 8),    # no span open
    _dev("orphan_k", 1060, 10, 99),                   # no launch found
    _x("cudaMemcpy", "cuda_runtime", 1080, 5),        # a sync outside
    _launch(9, 40), _dev("early_k", 50, 40, 9),       # before the window
    # the device-side copy of a span: no device work
    _x("ayq.forward", "gpu_user_annotation", 230, 230, tid=7),
]


def test_device_idle_and_instances_by_span():
    sp = trace.summarize(SPAN_EVENTS, "benchmark.profiled")
    flat = {(span, op): s for span, ops in sp.device_s_by_span.items()
            for op, s in ops.items()}
    assert flat == pytest.approx({
        ("ayq.quantize", "quant_k"): 50e-6,
        ("ayq.forward.conv.L1", "conv_wgmma<3>"): 170e-6,
        ("ayq.forward.concat", "cat_k"): 50e-6,
        ("ayq.forward", "copy_k"): 10e-6,
        ("ayq.nms.sweep", "gemv"): 40e-6,
        ("ayq", "Memcpy DtoH"): 20e-6,
        (trace.OUTSIDE, "late_k"): 30e-6, (trace.OUTSIDE, "orphan_k"): 10e-6})
    # busy [130,180) [230,460) [630,650) [720,740) [960,980) [1020,1050)
    # [1060,1070); each gap at its midpoint: 115 quantize, 205 and 545
    # forward, 685 the first sweep, 850 nms, 1000, 1055, 1085 outside
    assert sp.idle_by_span == pytest.approx({
        "ayq.quantize": 30e-6, "ayq.forward": 220e-6,
        "ayq.nms.sweep": 70e-6, "ayq.nms": 220e-6, trace.OUTSIDE: 80e-6})
    assert sp.span_counts == {"ayq": 1, "ayq.quantize": 1, "ayq.forward": 1,
                              "ayq.forward.conv.L1": 1,
                              "ayq.forward.concat": 1, "ayq.nms": 1,
                              "ayq.nms.sweep": 2}
    assert sp.syncs_by_span == {"ayq.nms.sweep": 1, trace.OUTSIDE: 1}
    assert spans.device_s(sp, "ayq.forward") == pytest.approx(230e-6)
    assert spans.device_s(sp, "ayq.forward", spans.PORT_KERNELS) == \
        pytest.approx(60e-6)
    assert spans.device_s(sp, "ayq") == pytest.approx(340e-6)
    assert spans.idle_s(sp, "ayq.nms") == pytest.approx(290e-6)
    assert spans.idle_s(sp, "ayq.n") == 0.0
    total = sum(sum(ops.values()) for ops in sp.device_s_by_span.values())
    assert total == pytest.approx(sum(sp.device_s_by_name.values()))
    assert sum(sp.idle_by_span.values()) == pytest.approx(
        sp.span_s - sp.busy_s)


STAGES = {
    "ingest_ms": 0.0, "quantize_ms": 0.025, "forward_glue_ms": 0.03,
    "forward_idle_ms": 0.11, "decode_ms": 0.0, "nms_ms": 0.02,
    "nms_sweeps": 1.0, "nms_idle_ms": 0.145}


def test_breakdown_covers_the_torch_glue():
    s = trace.summarize(SPAN_EVENTS, "benchmark.profiled")
    b = spans.breakdown(s, 2, {"L1": 40e-6})
    assert b["stages"] == pytest.approx(STAGES)
    # the rest: the root's copy back and the two kernels outside
    assert b["check"]["rest_ms"] == pytest.approx(0.03)
    assert b["check"]["stages_and_rest_ms"] == pytest.approx(
        b["check"]["torch_ops_ms"])
    assert b["conv_layers"] == [pytest.approx(
        {"layer": "L1", "kernel_ms": 0.085, "glue_ms": 0.0,
         "bound_ms": 0.04})]
    assert b["forward_glue_by_kind_ms"]["concat"] == pytest.approx(0.025)
    assert b["forward_glue_by_kind_ms"]["forward self"] == pytest.approx(
        0.005)
    assert b["by_span"]["ayq.nms.sweep"]["count"] == 1.0
    assert b["by_span"]["ayq.nms.sweep"]["syncs"] == 0.5
    assert b["check"]["host_syncs"] == b["check"]["syncs_by_span"] == 1.0


INGEST_EVENTS = [
    _ann("benchmark.profiled", 0, 100),
    _ann("ayq.ingest", 0, 60), _ann("ayq.ingest.stage", 10, 40),
    _launch(1, 15), _dev("Memcpy HtoD (Pinned -> Device)", 20, 25, 1,
                         "gpu_memcpy"),
    _ann("ayq.quantize", 60, 30),
    _launch(2, 62), _dev("quant_k", 70, 20, 2),
]


@pytest.mark.parametrize("events,steps,want", (
    (SPAN_EVENTS, 2, STAGES),
    # the ingest's device time counts its H2D copy (25 us); its idle:
    # [0, 20) in the stage, [45, 70) at 57.5 in the ingest ([90, 100) is
    # outside the program)
    (INGEST_EVENTS, 1, dict(dict.fromkeys(STAGES, 0.0),
                            ingest_ms=0.07, quantize_ms=0.02))),
    ids=("spans", "ingest"))
def test_each_stage_metric_reads_the_summary(events, steps, want):
    """Each span metric's reader gives the stage reading of the run's
    trace summary, as the breakdown does; without device events, None."""
    def read(k, window):
        return spec.reader(f"{k}.offline")(SimpleNamespace(window=window))

    names = {f"{k}.offline" for k in STAGES}
    assert names <= {m["name"] for m in spec.load()["per_layer"]}
    s = trace.summarize(events, "benchmark.profiled")
    assert spans.breakdown(s, steps)["stages"] == pytest.approx(want)
    w = loops.Window(seconds=1.0, setup_end=0.0, images=8, batch=4,
                     steps_profiled=steps, trace=s)
    for k in STAGES:
        assert read(k, w) == pytest.approx(want[k]), k
    hostonly = trace.summarize([e for e in events
                                if e.get("cat") not in trace.DEVICE_CATS],
                               "benchmark.profiled")
    for window in (loops.Window(1.0, 0.0, 8, 4, steps_profiled=steps,
                                trace=hostonly),
                   loops.Window(1.0, 0.0, 8, 4)):
        assert all(read(k, window) is None for k in STAGES)


def test_the_other_per_layer_readers_read_as_without_spans():
    """The six readers that read the trace's own fields give, on a trace
    with spans, what the arithmetic of those fields gives by hand."""
    events = SPAN_EVENTS + [
        _ann("ayq.ingest", 1000, 5), _launch(10, 1001),
        _dev("Memcpy HtoD (Pinned -> Device)", 1090, 8, 10, "gpu_memcpy")]
    w = loops.Window(seconds=1.5, setup_end=0.0, images=12, batch=4,
                     steps_profiled=2,
                     trace=trace.summarize(events, "benchmark.profiled"))
    run = SimpleNamespace(window=w, macs_per_image=10 ** 9,
                          forward_bound_s=lambda b: 2e-5 * b)
    want = {
        # 8 img/s x 2 x 1e9 MACs over 1.979e15 op/s
        "mfu.offline": 100 * 8 * 2e9 / 1.979e15,
        # 2 steps x the bound of a batch of 4 over the conv's 170 us
        "conv_roofline.offline": 100 * 2 * 8e-5 / 170e-6,
        # 388 us of device work less the conv and the H2D copy, a step
        "torch_ops_ms.offline": (388 - 170 - 8) / 2e3,
        "h2d_ms.offline": 8 / 2e3,
        # the stream sync and the plain copy
        "host_syncs.offline": 1.0,
        "device_idle.offline": 100 * (1 - 388 / 1000),
    }
    for name, value in want.items():
        assert spec.reader(name)(run) == pytest.approx(value), name


def test_traced_cpu_run_counts_the_spans(tiny_root, one_thread):
    out = spans.traced_run("yolov8n-offline-u8", SEED, 0.3, "cpu",
                           tiny_root)["result"]
    assert out["correct"] and list(out)[-1] == "checks"
    b = out["spans"]
    # no device on the CPU: nothing timed, every stage counted
    assert b["check"]["torch_ops_ms"] == 0.0 and b["check"]["share"] is None
    counts = {n: v["count"] for n, v in b["by_span"].items()}
    for name in ("ayq", "ayq.ingest", "ayq.quantize", "ayq.forward",
                 "ayq.forward.head_requant", "ayq.decode", "ayq.nms"):
        assert counts[name] == 1.0, name
    assert b["stages"]["nms_sweeps"] >= 1.0
    assert b["stages"]["nms_ms"] is None and b["stages"]["nms_idle_ms"] is None
    assert sum(n.startswith(spans.CONV) for n in counts) == 63
