"""The port's spans (utils/profiling.span, SPANS) on the CPU: off while no
torch profiler runs, one span of each pipeline stage a call under one,
nested as their dotted names say, one ``ayq.nms.sweep`` a sweep of the
keep-mask loop, one ``ayq.ingest.stage`` a chunk of the staged ingest, and
the same detections with the profiler on and off."""

import collections

import numpy as np
import pytest

import torch

from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.engine_profile import STAGES, stage_torch_ops_ms
from alpha_yolo_quant_torch.models.graph import (
    ConcatNode, ConvNode, MaxPoolNode, ResidualAddNode, SplitNode,
    UpsampleNode, build_yolov8_graph,
)
from alpha_yolo_quant_torch.models.params import init_params
from alpha_yolo_quant_torch.postprocess import nms
from alpha_yolo_quant_torch.quantize.calibrate import (
    collect_stats, reduce_stats,
)
from alpha_yolo_quant_torch.quantize.transform import build_quantized_model
from alpha_yolo_quant_torch.runtime import ingest
from alpha_yolo_quant_torch.runtime.interpreter import (
    build_int_pipeline, slab_plan,
)
from alpha_yolo_quant_torch.utils import profiling
from test_torch_ingest import FakeEvent, fake_cuda  # noqa: F401
from test_torch_model_build import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 64
GLUE = {SplitNode: "ayq.forward.split", ResidualAddNode: "ayq.forward.add",
        ConcatNode: "ayq.forward.concat", MaxPoolNode: "ayq.forward.maxpool",
        UpsampleNode: "ayq.forward.upsample"}


@pytest.fixture(scope="module")
def model():
    cfg = QuantConfig(model="yolov8n", k=8, full_quant=True, image_size=SIZE)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=3)
    calib = np.random.default_rng(3).uniform(
        0, 1, (2, 3, SIZE, SIZE)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib], "cpu"),
                         "max", cfg.k)
    return build_quantized_model(graph, params, max_a, cfg)


def _images(n, seed=5):
    return np.random.default_rng(seed).integers(
        0, 256, (n, 3, SIZE, SIZE)).astype(np.uint8)


def _profiled(call):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = call()
    return out, [e for e in prof.events() if _is_span(e.name)]


def _is_span(name):
    return name.partition(".")[0] == "ayq"


def _expected_parent(name):
    """The longest span name of SPANS that, with a dot, starts ``name``
    (names ending in a dot take a suffix and name no span)."""
    cands = [p for p in profiling.SPANS
             if not p.endswith(".") and name.startswith(p + ".")]
    return max(cands, key=len, default=None)


def _innermost_parent(span, spans):
    """The shortest span of the same thread that encloses ``span``."""
    outer = [s for s in spans if s is not span and s.thread == span.thread
             and s.time_range.start <= span.time_range.start
             and s.time_range.end >= span.time_range.end]
    return min(outer, key=lambda s: s.time_range.elapsed_us(),
               default=None)


def _in_table(name):
    return name in profiling.SPANS or any(
        p.endswith(".") and name.startswith(p) for p in profiling.SPANS)


def test_span_is_the_shared_null_context_while_no_profiler_runs(
        model, monkeypatch):
    made = []

    class Counting(torch.autograd.profiler.record_function):
        def __init__(self, name, args=None):
            made.append(name)
            super().__init__(name, args)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    off = profiling.span("ayq.forward.conv.", "Conv_P1")
    assert off is profiling.span("ayq") is profiling._OFF
    with off:
        pass
    fn, _ = build_int_pipeline(model, "cpu")
    fn(_images(1))
    assert made == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("ayq.forward.conv.", "Conv_P1"):
            pass
    assert made == ["ayq.forward.conv.Conv_P1"]


@pytest.mark.parametrize("engine,requests", [("fused", 1), ("packed", 1),
                                             ("fused", 2)])
def test_pipeline_call_emits_each_stage_span_nested_by_name(
        model, engine, requests):
    """One call: ``ayq`` once; ingest and quantize once a request;
    forward, head_requant, decode and nms once; one conv span a conv layer
    outside the slabs and one glue span a node of that kind (the packed
    engine runs the slab region as ``ayq.forward.slab``). Every span's
    innermost enclosing span is the one its name prefixes."""
    fn, plan = build_int_pipeline(model, "cpu", engine=engine,
                                  coalesce_requests=(requests if requests > 1
                                                     else None))
    reqs = [_images(2, seed=s) for s in range(requests)]
    _, spans = _profiled(lambda: fn(*reqs))
    names = collections.Counter(s.name for s in spans)
    for name in names:
        assert _in_table(name), name
    for name in ("ayq", "ayq.forward", "ayq.forward.head_requant",
                 "ayq.decode", "ayq.nms", "ayq.nms.select",
                 "ayq.nms.suppress", "ayq.nms.compact"):
        assert names[name] == 1, name
    assert names["ayq.ingest"] == names["ayq.quantize"] == requests
    assert names["ayq.nms.sweep"] >= 1
    slab_nodes = (slab_plan(model, plan).nodes if engine == "packed"
                  else set())
    nodes = [(i, n) for i, n in enumerate(model.graph.nodes)
             if i not in slab_nodes]
    convs = {f"ayq.forward.conv.{n.name}" for _, n in nodes
             if isinstance(n, ConvNode)}
    assert {n for n in names if n.startswith("ayq.forward.conv.")} == convs
    assert all(names[c] == 1 for c in convs)
    for kind, name in GLUE.items():
        assert names[name] == sum(isinstance(n, kind) for _, n in nodes)
    assert (names["ayq.forward.slab"] > 0) == (engine == "packed")
    for s in spans:
        parent = _innermost_parent(s, spans)
        assert (parent.name if parent else None) == _expected_parent(s.name)


def _sweeps(boxes, valid, p):
    """The number of iterations of greedy_keep_sorted's loop, by a copy of
    the loop."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1 + p.plus_one) * (y2 - y1 + p.plus_one)
    m = boxes.shape[-2]
    sup = nms._suppress_matrix(boxes, areas, p.iou_thres, p.plus_one,
                               p.quantized)
    s = (sup & torch.ones(m, m, dtype=torch.bool).triu(1)).to(torch.float32)
    keep, n = valid, 0
    while True:
        n += 1
        killed = torch.matmul(keep.to(torch.float32).unsqueeze(-2),
                              s).squeeze(-2) > 0.5
        nxt = valid & ~killed
        if torch.equal(nxt, keep):
            return n
        keep = nxt


def _chain(m):
    """Boxes each overlapping the next alone: greedy keeps every other
    one, and the Jacobi sweeps settle one box a sweep."""
    x = torch.arange(m, dtype=torch.float32) * 4.0
    return torch.stack((x, torch.zeros(m), x + 10.0, torch.full((m,), 10.0)),
                       -1)


@pytest.mark.parametrize("name", ["ayq.ingest.stage", "ayq.ingest.wait"])
def test_staged_ingest_spans_are_listed_under_the_ingest(name):
    assert name in profiling.SPANS
    assert _expected_parent(name) == "ayq.ingest"


@pytest.mark.parametrize("busy", [False, True])
def test_one_stage_span_a_chunk_nested_in_the_ingest(fake_cuda, monkeypatch,
                                                     busy):
    """The ring's loop over stand-in streams and events (test_torch_ingest)
    under a profiler: one ``ayq.ingest.stage`` a chunk, one
    ``ayq.ingest.wait`` a wait (none while every slot comes back free),
    each inside ``ayq.ingest`` (opened here as the pipeline opens it)."""
    monkeypatch.setattr(ingest, "CHUNK_BYTES", 1000)
    monkeypatch.setattr(ingest, "SLOTS", 2)
    monkeypatch.setattr(FakeEvent, "busy", busy)
    x = torch.arange(4500, dtype=torch.int32).to(torch.uint8)
    st = ingest.StagedIngest("cpu")

    def call():
        with profiling.span("ayq"), profiling.span("ayq.ingest"):
            return st._staged(x)
    got, spans = _profiled(call)
    assert torch.equal(got, x)
    names = collections.Counter(s.name for s in spans)
    assert names["ayq.ingest.stage"] == 5 == ingest.STAGED["chunks"]
    assert names["ayq.ingest.wait"] == (3 if busy else 0)
    for s in spans:
        assert _in_table(s.name), s.name
        parent = _innermost_parent(s, spans)
        assert (parent.name if parent else None) == _expected_parent(s.name)


@pytest.mark.parametrize("case", ["chain", "random"])
def test_one_sweep_span_a_sweep_of_the_keep_loop(case):
    p = nms.NmsParams(iou_thres=0.3)
    if case == "chain":
        boxes = torch.stack((_chain(24), _chain(24) + 1.0))
    else:
        g = torch.Generator().manual_seed(7)
        xy = torch.rand(2, 40, 2, generator=g) * 60
        wh = torch.rand(2, 40, 2, generator=g) * 30 + 4
        boxes = torch.cat((xy, xy + wh), -1)
    valid = torch.ones(boxes.shape[:2], dtype=torch.bool)
    valid[1, -3:] = False
    want = _sweeps(boxes, valid, p)
    keep, spans = _profiled(lambda: nms.greedy_keep_sorted(
        boxes, valid, p.iou_thres, p.max_det, p.plus_one, p.quantized))
    names = collections.Counter(s.name for s in spans)
    assert names["ayq.nms.sweep"] == want
    assert names["ayq.nms.suppress"] == 1
    assert want > (10 if case == "chain" else 1)
    assert torch.equal(keep, nms.greedy_keep_sorted(
        boxes, valid, p.iou_thres, p.max_det, p.plus_one, p.quantized))


@pytest.mark.parametrize("engine", ["fused", "packed"])
def test_detections_bit_identical_with_the_profiler_on_and_off(model,
                                                              engine):
    fn, _ = build_int_pipeline(model, "cpu", engine=engine)
    x = _images(3, seed=9)
    det, n = fn(x)
    (det_on, n_on), spans = _profiled(lambda: fn(x))
    assert spans
    assert n.dtype == n_on.dtype and torch.equal(n, n_on)
    assert det.dtype == det_on.dtype and torch.equal(det, det_on)
    assert int(n.sum()) > 0


def test_stage_torch_ops_ms_sums_the_host_side_stage_spans():
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    Evt = collections.namedtuple("Evt", "key device_type device_time_total")
    events = [Evt("ayq.forward", cpu, 5000.0), Evt("ayq.forward", cuda, 9e9),
              Evt("ayq.nms", cpu, 1500.0), Evt("ayq.nms.sweep", cpu, 700.0),
              Evt("aten::add", cpu, 30.0), Evt("ayq.decode", cpu, 250.0)]
    assert stage_torch_ops_ms(events) == {"ayq.quantize": 0.0,
                                          "ayq.forward": 5.0,
                                          "ayq.decode": 0.25, "ayq.nms": 1.5}
    assert tuple(stage_torch_ops_ms([])) == STAGES
