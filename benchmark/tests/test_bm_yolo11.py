"""The YOLO11 cell on the CPU, in the shared tiny tree (every configuration
at 64 px, the mix shrunk): the configuration file is held to the graph it
names, a run is correct and its control is not, the cell resolves with
its metrics, and the depthwise, attention and dense-conv roofline readers
read a synthetic trace."""

import json
from types import SimpleNamespace

import pytest

from benchmark import control, counts, counts_yolo11, loops, run, spec, trace

CELL = "yolo11m-offline-u8"
SEED = 2 ** 31 + 29
NEW = ("dwconv_roofline.offline", "attn_roofline.offline",
       "dense_conv_roofline.offline")


def test_the_configuration_states_the_graph():
    """check_config accepts yolo11m-int8-640.json as it is: 112 convs,
    20,068,288 conv weights (a depthwise conv counts cout * 1 * 9), no
    reduced key."""
    bench = spec.load()
    cell = spec.cell(bench, CELL)
    graph = spec.reference(cell.config).graph.build_yolov8_graph(
        run.ref_cfg(cell.config))
    run.check_config(cell.config, graph)
    assert (cell.config["convs"], cell.config["conv_weights"]) == \
        (112, 20_068_288)
    (entry,) = [c for c in bench["configs"]
                if c["name"] == cell.config["name"]]
    assert entry["reduced"] == []


def test_a_wrong_conv_count_is_refused(tiny_root):
    p = tiny_root / "benchmark" / "configs" / "yolo11m-int8-640.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), convs=105)))
    with pytest.raises(ValueError, match="convs"):
        run.run_cell(CELL, SEED, 0.3, False, "cpu", tiny_root)


def test_cpu_run_of_the_yolo11_cell_is_correct(tiny_root, one_thread):
    out = run.run_cell(CELL, SEED, 0.3, False, "cpu", tiny_root)["result"]
    assert out["correct"], out["checks"]
    assert out["checks"]["answers_compared"]["value"] > 0
    assert set(out["metrics"]) == {"throughput", "setup_s"}


def test_control_of_the_yolo11_cell_is_not_correct(tiny_root, one_thread):
    out = control.control_run(CELL, SEED, 0.3, "cpu", tiny_root)
    assert not out["correct"]
    assert out["checks"]["answers_wrong"]["value"] > 0


def test_the_cell_resolves_with_its_metrics():
    """The cell runs yolo11m on the existing offline-u8-b128 mix on one
    chip, and reports every per-layer metric but conv_roofline.offline
    and p6_conv_ms.offline, with its three own."""
    bench = spec.load()
    cell = spec.cell(bench, CELL)
    assert (cell.chips, cell.traffic["name"], cell.config["model"]) == \
        (1, "offline-u8-b128", "yolo11m")
    assert [m["name"] for m in spec.metrics(bench, CELL, False)] == \
        ["throughput", "peak_mem_gib", "setup_s"]
    names = {m["name"] for m in spec.metrics(bench, CELL, True)}
    every = {m["name"] for m in bench["per_layer"]}
    assert names == every - {"conv_roofline.offline", "p6_conv_ms.offline"}
    for other in ("yolov8n-offline-u8", "yolov8m-p6-offline-u8"):
        assert not names.isdisjoint(
            m["name"] for m in spec.metrics(bench, other, True))
        assert not set(NEW) & {m["name"] for m in
                               spec.metrics(bench, other, True)}


def _run(device_s, bound_s=0.010, batch=128):
    """A Run of 2 profiled steps whose trace holds ``device_s`` (kernel
    name -> seconds) and whose forward bound is ``bound_s`` a batch."""
    s = trace.Summary(span_s=1.0, busy_s=0.5, device_s_by_name=device_s,
                      syncs=0, idle_by_host_op={}, device_s_by_span={},
                      idle_by_span={}, span_counts={}, syncs_by_span={})
    w = loops.Window(seconds=1.0, setup_end=0.0, images=2 * batch,
                     batch=batch, steps_profiled=2, trace=s)
    return SimpleNamespace(cell=spec.cell(spec.load(), CELL), window=w,
                           forward_bound_s=lambda b: bound_s * b / batch)


def test_the_roofline_readers_read_their_kernels():
    """Each new share is 2 steps x its bound over its kernel's seconds;
    None without that kernel in the trace."""
    config = spec.cell(spec.load(), CELL).config
    graph, shapes = counts_yolo11.cell_graph(config)
    dw = counts_yolo11.depthwise_bound_s(graph, shapes, 128)
    att = counts_yolo11.attention_bound_s(graph, shapes, 128)
    assert dw == pytest.approx(0.3756e-3, rel=1e-3)
    assert att == pytest.approx(0.01174e-3, rel=1e-3)
    ops = {"void (anonymous namespace)::dwconv3x3_kernel(...)": 2e-3,
           "void (anonymous namespace)::attn_kernel(...)": 1e-4,
           "void ayq::conv_wgmma_ws<3, 64, true>(ayq::ConvArgs)": 0.05,
           "elementwise": 1.0}
    r = _run(ops)
    read = {n: spec.reader(n) for n in NEW}
    assert read["dwconv_roofline.offline"](r) == pytest.approx(
        100 * 2 * dw / 2e-3)
    assert read["attn_roofline.offline"](r) == pytest.approx(
        100 * 2 * att / 1e-4)
    dense = 0.010 - counts_yolo11.conv_bound_s_as_counted(graph, shapes, 128)
    assert read["dense_conv_roofline.offline"](r) == pytest.approx(
        100 * 2 * dense / 0.05)
    assert all(read[n](_run({"elementwise": 1.0})) is None for n in NEW)


def test_the_dense_share_leaves_out_what_counts_gives_the_depthwise():
    """counts.forward_bound_s of the whole graph less the depthwise convs'
    share as counted there is the bound of the dense convs alone."""
    config = spec.cell(spec.load(), CELL).config
    graph, shapes = counts_yolo11.cell_graph(config)
    amax = {n.src: 127 for n in graph.convs()}
    dense = SimpleNamespace(convs=lambda: [n for n in graph.convs()
                                           if n.groups == 1])
    whole = counts.forward_bound_s(graph, shapes, amax, 128)
    assert whole - counts_yolo11.conv_bound_s_as_counted(
        graph, shapes, 128) == pytest.approx(
        counts.forward_bound_s(dense, shapes, amax, 128), rel=1e-12)
