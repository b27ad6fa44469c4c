"""The port's request coalescing (alpha_yolo_quant_torch/serving.py): the
cases of tests/test_serving.py against the port's CPU pipeline. Every
parity assert is array_equal: the outputs of a coalesced flush must equal
the request run alone, bit for bit (batch independence)."""

import os
import sys
import threading
import time

import numpy as np
import pytest

import conftest  # noqa: F401

import torch

from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.models.graph import build_yolov8_graph
from alpha_yolo_quant_torch.models.params import init_params
from alpha_yolo_quant_torch.quantize.calibrate import (
    collect_stats, reduce_stats,
)
from alpha_yolo_quant_torch.quantize.transform import build_quantized_model
from alpha_yolo_quant_torch.runtime.interpreter import build_int_pipeline
from alpha_yolo_quant_torch.serving import BatchCoalescer, coalesced_fn

RNG = np.random.default_rng(43)
SIZE = 64


@pytest.fixture(scope="module")
def fn():
    cfg = QuantConfig(model="yolov8n", image_size=SIZE, full_quant=True)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=0)
    calib = RNG.uniform(0, 1, (2, 3, SIZE, SIZE)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib], "cpu"))
    model = build_quantized_model(graph, params, max_a, cfg)
    return build_int_pipeline(model, "cpu")[0]


def _req(b, dtype=np.float32):
    if dtype == np.uint8:
        return RNG.integers(0, 256, (b, 3, SIZE, SIZE)).astype(np.uint8)
    return RNG.uniform(0, 1, (b, 3, SIZE, SIZE)).astype(np.float32)


def _alone(fn, r):
    det, n = fn(r)
    return det.numpy(), n.numpy()


def _assert_equal(got, want):
    det, n_det = got
    assert isinstance(det, np.ndarray) and isinstance(n_det, np.ndarray)
    np.testing.assert_array_equal(det, want[0])
    np.testing.assert_array_equal(n_det, want[1])


@pytest.mark.parametrize("sizes", [(2, 2), (1, 3, 2)])
def test_coalesced_fn_bitwise_matches_per_request(fn, sizes):
    reqs = [_req(b) for b in sizes]
    parts = coalesced_fn(fn, n_requests=len(sizes))(*reqs)
    assert len(parts) == len(sizes)
    for r, (det, n_det) in zip(reqs, parts):
        _assert_equal((det.numpy(), n_det.numpy()), _alone(fn, r))
    with pytest.raises(ValueError):
        coalesced_fn(fn, n_requests=3)(reqs[0])


def test_coalescer_fills_and_flushes_bitwise(fn):
    with BatchCoalescer(fn, max_batch=8, max_wait_ms=10_000,
                        image_shape=(3, SIZE, SIZE)) as co:
        reqs = [_req(3), _req(5)]   # fills 8 exactly -> immediate flush
        futs = [co.submit(r) for r in reqs]
        for r, f in zip(reqs, futs):
            _assert_equal(f.result(timeout=300), _alone(fn, r))
        assert co.snapshot()["flushes"] == 1


def test_coalescer_timeout_flushes_partial_at_real_rows(fn):
    """A timed-out flush runs at its real row count (no zero padding);
    mean_fill stays real rows / max_batch."""
    seen = []

    def step(x):
        seen.append(x.shape[0])
        return fn(x)

    with BatchCoalescer(step, max_batch=8, max_wait_ms=50,
                        image_shape=(3, SIZE, SIZE)) as co:
        r = _req(2)
        t0 = time.monotonic()
        got = co.submit(r).result(timeout=300)
        assert time.monotonic() - t0 >= 0.045  # waited for the timeout
        _assert_equal(got, _alone(fn, r))
        stats = co.snapshot()
    assert seen == [2]
    assert stats["flushes"] == 1 and stats["mean_fill"] == 2 / 8


def test_coalescer_uint8_requests(fn):
    with BatchCoalescer(fn, max_batch=8, max_wait_ms=20,
                        image_shape=(3, SIZE, SIZE), dtype=np.uint8) as co:
        reqs = [_req(2, np.uint8), _req(3, np.uint8)]
        futs = [co.submit(r) for r in reqs]
        for r, f in zip(reqs, futs):
            _assert_equal(f.result(timeout=300), _alone(fn, r))


def test_coalescer_concurrent_submitters(fn):
    reqs = [_req(b) for b in (1, 2, 3, 2, 4, 2, 1, 1)]
    want = [_alone(fn, r) for r in reqs]
    results = {}
    with BatchCoalescer(fn, max_batch=8, max_wait_ms=30,
                        image_shape=(3, SIZE, SIZE)) as co:
        def worker(i):
            results[i] = co.submit(reqs[i]).result(timeout=300)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        stats = co.snapshot()
    for i in range(len(reqs)):
        _assert_equal(results[i], want[i])
    # every request and image accounted for, latency quantiles populated,
    # mean fill in (0, 1]
    assert stats["requests"] == len(reqs)
    assert stats["images"] == sum(r.shape[0] for r in reqs)
    assert stats["flushes"] >= 2          # 16 images through max_batch 8
    assert 0 < stats["mean_fill"] <= 1.0
    assert stats["latency_ms_p50"] > 0
    assert stats["latency_ms_p99"] >= stats["latency_ms_p50"]


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_coalescer_worker_death_fails_futures():
    """A BaseException from the step (SystemExit & co.) resolves the
    in-flight future with it and closes the coalescer."""

    def bad(x):
        raise SystemExit("step died")

    co = BatchCoalescer(bad, max_batch=4, max_wait_ms=10,
                        image_shape=(3, 8, 8))
    fut = co.submit(np.zeros((1, 3, 8, 8), np.float32))
    with pytest.raises(SystemExit):
        fut.result(timeout=60)
    # the worker is dead: new submits are refused (racing with the _run
    # handler that flips _closed, so poll briefly)
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            co.submit(np.zeros((1, 3, 8, 8), np.float32))
            time.sleep(0.02)
        except RuntimeError:
            break
    else:
        pytest.fail("coalescer still accepting after worker death")


def test_coalescer_soak_storm(fn):
    """Randomized concurrent traffic through the real pipeline: request
    sizes 1..max_batch, bursts, timeout flushes. Every response equals
    the same request run alone; no future is left unresolved and the
    stats account for every request and image."""
    MB = 4
    results = []               # (request, future)
    res_lock = threading.Lock()

    def submitter(seed):
        rng = np.random.default_rng(seed)
        for _ in range(2):
            burst = []
            for _ in range(int(rng.integers(1, 4))):    # bursts of 1-3
                r = rng.uniform(0, 1, (int(rng.integers(1, MB + 1)),
                                       3, SIZE, SIZE)).astype(np.float32)
                burst.append((r, co.submit(r)))
            with res_lock:
                results.extend(burst)
            for _, f in burst:   # back-pressure before the next burst
                f.result(timeout=600)
            # idle gaps exercise the timeout-flush path
            time.sleep(float(rng.choice([0.0, 0.02, 0.06])))

    with BatchCoalescer(fn, max_batch=MB, max_wait_ms=8,
                        image_shape=(3, SIZE, SIZE)) as co:
        threads = [threading.Thread(target=submitter, args=(1000 + i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not any(t.is_alive() for t in threads)
        stats = co.snapshot()
    for r, f in results:
        _assert_equal(f.result(timeout=0), _alone(fn, r))
    assert stats["requests"] == len(results) >= 8
    assert stats["images"] == sum(r.shape[0] for r, _ in results)
    assert stats["flushes"] >= 2
    assert 0 < stats["mean_fill"] <= 1.0
    assert stats["latency_ms_p99"] >= stats["latency_ms_p50"] > 0


def test_coalescer_stress_more_threads_than_cores():
    """Many more submitter threads than cores, a short switch interval:
    every row comes back to its own request (a lost or crossed update
    would break the per-row sums) and the counters add up exactly."""
    n_threads, per_thread = 4 * (os.cpu_count() or 1) + 1, 30

    def step(x):
        x = torch.as_tensor(x)
        return x.sum(dim=(1, 2, 3)), torch.full((x.shape[0],), x.shape[0],
                                                dtype=torch.int32)

    failures = []

    def submitter(seed):
        rng = np.random.default_rng(seed)
        try:
            for _ in range(per_thread):
                r = rng.integers(0, 100, (int(rng.integers(1, 5)), 3, 4, 4)
                                 ).astype(np.float32)
                s, n = co.submit(r).result(timeout=120)
                if not (np.array_equal(s, r.sum(axis=(1, 2, 3)))
                        and (n >= r.shape[0]).all() and (n <= 16).all()):
                    failures.append(seed)
        except Exception as e:
            failures.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with BatchCoalescer(step, max_batch=16, max_wait_ms=1,
                            image_shape=(3, 4, 4)) as co:
            threads = [threading.Thread(target=submitter, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            assert not any(t.is_alive() for t in threads)
            stats = co.snapshot()
    finally:
        sys.setswitchinterval(interval)
    assert not failures
    assert stats["requests"] == n_threads * per_thread
    assert stats["flushes"] < stats["requests"]    # requests coalesced
    assert 0 < stats["mean_fill"] <= 1.0


def test_coalescer_poisoned_flush_does_not_kill_worker():
    """An Exception raised by the step for one flush fails exactly that
    flush's futures and leaves the worker serving later requests."""

    def step(x):
        x = torch.as_tensor(x)
        if bool((x == 1234.5).any()):
            raise ValueError("poisoned batch")
        return x.sum(dim=(1, 2, 3)), torch.zeros(x.shape[0],
                                                 dtype=torch.int32)

    good = np.ones((2, 3, 8, 8), np.float32)
    poison = np.full((1, 3, 8, 8), 1234.5, np.float32)
    with BatchCoalescer(step, max_batch=4, max_wait_ms=10,
                        image_shape=(3, 8, 8)) as co:
        with pytest.raises(ValueError, match="poisoned batch"):
            co.submit(poison).result(timeout=120)
        s, n = co.submit(good).result(timeout=120)
        np.testing.assert_array_equal(s, good.sum(axis=(1, 2, 3)))


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_coalescer_worker_death_under_concurrent_storm():
    """A SystemExit in the step while many submitters are in flight: every
    future resolves (result or exception) and new work is refused."""

    def bad(x):
        raise SystemExit("step died mid-storm")

    co = BatchCoalescer(bad, max_batch=8, max_wait_ms=20,
                        image_shape=(3, 8, 8))
    futs = []
    futs_lock = threading.Lock()

    def submitter(i):
        for _ in range(5):
            try:
                f = co.submit(np.zeros((1, 3, 8, 8), np.float32))
            except RuntimeError:
                return                       # already closed: fine
            with futs_lock:
                futs.append(f)
            time.sleep(0.005)

    threads = [threading.Thread(target=submitter, args=(i,))
               for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert futs, "storm submitted nothing before the death"
    for f in futs:
        with pytest.raises(SystemExit):
            f.result(timeout=120)            # resolved, not stranded


def test_coalescer_rejects_bad_requests(fn):
    with BatchCoalescer(fn, max_batch=8, max_wait_ms=10,
                        image_shape=(3, SIZE, SIZE)) as co:
        with pytest.raises(ValueError):
            co.submit(_req(9))
        with pytest.raises(ValueError):
            co.submit(np.zeros((2, 3, SIZE, SIZE // 2), np.float32))
        with pytest.raises(ValueError):
            co.submit(np.zeros((3, SIZE, SIZE), np.float32))
    with pytest.raises(RuntimeError):
        co.submit(_req(1))
