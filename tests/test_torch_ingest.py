"""The staged ingest (runtime/ingest.py) on the CPU: the chunk plan, a CPU
pipeline that never stages, and the ring's loop over a stand-in for the
CUDA stream, events and pinned memory, so that its bytes, its counter, its
slot reuse and its waits are checked without a card. On the card
tests/test_torch_gpu.py holds it to torch.as_tensor and the pipeline's
detections."""

import contextlib
import sys
import threading

import numpy as np
import pytest
import torch

from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.models.graph import build_yolov8_graph
from alpha_yolo_quant_torch.models.params import init_params
from alpha_yolo_quant_torch.quantize.calibrate import (
    collect_stats, reduce_stats,
)
from alpha_yolo_quant_torch.quantize.transform import build_quantized_model
from alpha_yolo_quant_torch.runtime import ingest
from alpha_yolo_quant_torch.runtime.interpreter import build_int_pipeline
from test_torch_model_build import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = 64
B128_640 = 128 * 3 * 640 * 640     # a benchmark batch of uint8 images


@pytest.mark.parametrize("n_bytes,chunk", [
    (n, c) for c in (1, 4096) for n in (0, 1, 4095, 4096, 4097, 3 * 4096 + 7)]
    + [(0, 8 << 20), (4097, 8 << 20), (8 << 20, 8 << 20),
       ((8 << 20) + 1, 8 << 20), (B128_640, 8 << 20)])
def test_chunk_plan_covers_every_byte_once_in_order(n_bytes, chunk):
    plan = ingest.chunk_plan(n_bytes, chunk)
    assert len(plan) == -(-n_bytes // chunk)
    ends = [0] + [hi for _, hi in plan]
    assert [lo for lo, _ in plan] == ends[:-1]    # no gap, no overlap
    assert ends[-1] == n_bytes
    assert all(0 < hi - lo <= chunk for lo, hi in plan)
    assert all(hi - lo == chunk for lo, hi in plan[:-1])
    if 0 < n_bytes <= chunk:
        assert plan == [(0, n_bytes)]


def test_chunk_plan_of_a_single_image_request_is_one_chunk():
    one = 3 * 640 * 640
    assert ingest.chunk_plan(one, ingest.CHUNK_BYTES) == [(0, one)]


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


@pytest.mark.parametrize("coalesced", [False, True])
def test_cpu_pipeline_never_stages(model, coalesced):
    rng = np.random.default_rng(4)
    u8 = rng.integers(0, 256, (2, 3, SIZE, SIZE)).astype(np.uint8)
    f32 = rng.uniform(0, 1, (1, 3, SIZE, SIZE)).astype(np.float32)
    fn, _ = build_int_pipeline(model, "cpu",
                               coalesce_requests=2 if coalesced else None)
    ingest.reset_counts()
    if coalesced:
        fn(u8, torch.as_tensor(f32))
    else:
        fn(u8)
        fn(torch.as_tensor(f32))
    assert ingest.STAGED == {"calls": 0, "chunks": 0, "bytes": 0}
    x = ingest.StagedIngest("cpu")(u8)
    assert np.shares_memory(x.numpy(), u8)    # torch.as_tensor, as before


class FakeEvent:
    """A CUDA event whose copy, when ``FakeEvent.busy``, is still running
    until the host waits for it."""

    busy = False

    def __init__(self):
        self.running = False

    def record(self, stream=None):
        self.running = FakeEvent.busy

    def query(self):
        return not self.running

    def synchronize(self):
        self.running = False


class FakeStream:
    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_cuda(monkeypatch):
    """The ring's CUDA calls on the CPU: streams and events that do
    nothing (or report a copy running, ``FakeEvent.busy``), and pinned
    allocations made as plain ones and logged (their byte counts)."""
    real_empty = torch.empty
    pinned = []

    def empty(*args, pin_memory=False, **kw):
        if pin_memory:
            pinned.append(args[0])
        return real_empty(*args, **kw)

    monkeypatch.setattr(torch.cuda, "Stream", FakeStream)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: FakeStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch, "empty", empty)
    monkeypatch.setattr(FakeEvent, "busy", False)
    ingest.reset_counts()
    return pinned


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("b", [1, 3, 7])
@pytest.mark.parametrize("kind", ["numpy", "tensor"])
def test_ring_copies_every_byte_through_reused_slots(fake_cuda, monkeypatch,
                                                     dtype, b, kind):
    """Chunks of 1001 bytes (not a multiple of a float32) through 2
    slots: the device tensor equals the input, the counter counts each
    call, its chunks and bytes, and the slots are allocated once."""
    monkeypatch.setattr(ingest, "CHUNK_BYTES", 1001)
    monkeypatch.setattr(ingest, "SLOTS", 2)
    rng = np.random.default_rng(b)
    x = (rng.integers(0, 256, (b, 3, 9, 11)) if dtype == np.uint8
         else rng.uniform(0, 1, (b, 3, 9, 11))).astype(dtype)
    src = torch.as_tensor(x) if kind == "tensor" else x
    st = ingest.StagedIngest("cpu")
    for call in (1, 2):
        got = st._staged(torch.as_tensor(src))
        assert got.dtype == torch.as_tensor(x).dtype
        assert torch.equal(got, torch.as_tensor(x))
        assert not np.shares_memory(got.numpy(), x)
        chunks = -(-x.nbytes // 1001)
        assert ingest.STAGED == {"calls": call, "chunks": call * chunks,
                                 "bytes": call * x.nbytes}
    assert fake_cuda == [min(x.nbytes, 1001)] * min(2, chunks)


def test_ring_grows_its_slots_to_a_larger_request_once(fake_cuda,
                                                       monkeypatch):
    monkeypatch.setattr(ingest, "CHUNK_BYTES", 4096)
    monkeypatch.setattr(ingest, "SLOTS", 3)
    st = ingest.StagedIngest("cpu")
    small = torch.arange(100, dtype=torch.uint8)
    big = torch.arange(20000, dtype=torch.int32).to(torch.uint8)
    for x in (small, big, small, big):
        assert torch.equal(st._staged(x), x)
    assert fake_cuda == [100, 4096, 4096, 4096]


def test_caller_may_overwrite_its_array_once_the_call_returns(fake_cuda,
                                                              monkeypatch):
    monkeypatch.setattr(ingest, "CHUNK_BYTES", 333)
    x = np.random.default_rng(0).integers(0, 256, (2, 3, 8, 8)).astype(
        np.uint8)
    want = x.copy()
    got = ingest.StagedIngest("cpu")._staged(torch.as_tensor(x))
    x[...] = 255 - x
    assert torch.equal(got, torch.as_tensor(want))


def test_a_running_slot_is_waited_for_before_it_is_refilled(fake_cuda,
                                                           monkeypatch):
    """With every copy still running when the host comes back to its slot,
    each chunk past the ring's size waits once, inside its own
    ``ayq.ingest.wait`` span; the bytes are the same."""
    monkeypatch.setattr(ingest, "CHUNK_BYTES", 100)
    monkeypatch.setattr(ingest, "SLOTS", 3)
    monkeypatch.setattr(FakeEvent, "busy", True)
    names = []
    real_span = ingest.span

    def logged(name):
        names.append(name)
        return real_span(name)
    monkeypatch.setattr(ingest, "span", logged)
    x = torch.arange(1050, dtype=torch.int32).to(torch.uint8)
    assert torch.equal(ingest.StagedIngest("cpu")._staged(x), x)
    assert names.count("ayq.ingest.stage") == 11
    assert names.count("ayq.ingest.wait") == 11 - 3
    assert ingest.STAGED["chunks"] == 11


def test_threads_sharing_one_ring_never_share_a_slot(fake_cuda, monkeypatch):
    """16 threads, 20 calls each, on one ingest with 2 slots of 97 bytes
    and the interpreter switching threads every microsecond: each call
    gets its own bytes back and every call is counted (a slot refilled by
    another thread between a chunk's host copy and its device copy, or a
    lost counter update, would break one or the other)."""
    monkeypatch.setattr(ingest, "CHUNK_BYTES", 97)
    monkeypatch.setattr(ingest, "SLOTS", 2)
    st = ingest.StagedIngest("cpu")
    xs = [torch.full((1000,), k, dtype=torch.uint8) for k in range(16)]
    wrong = []

    def worker(k):
        for _ in range(20):
            if not torch.equal(st._staged(xs[k]), xs[k]):
                wrong.append(k)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(k,))
                   for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrong == []
    assert ingest.STAGED == {"calls": 320, "chunks": 320 * 11,
                             "bytes": 320 * 1000}
