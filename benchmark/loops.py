"""The general traffic generator's loop, driving the program's ``fn`` as
users do, with the measured window and the profiled steps after it.

A closed loop of back-to-back batches of ``batch`` images from a pool of
``pool_batches`` distinct host batches, each batch's detections copied to
the host before the next is sent (MLPerf Offline). It warms up the mix's
shape, then measures for ``seconds``; with ``trace`` it runs
``trace_steps`` more batches under torch.profiler. Answers of the sampled
pool images (``check_images`` of them, drawn from the seed) are kept for
the comparison with the reference.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from benchmark import inputs, trace as trace_mod

ANNOTATION = "benchmark.profiled"


@dataclasses.dataclass
class Window:
    seconds: float                   # length of the measured window
    setup_end: float                 # perf_counter at the first timed call
    images: int                      # images answered in the window
    batch: int                       # images per batch
    step_s: List[float] = dataclasses.field(default_factory=list)
    gc_pauses: List[Tuple[int, float]] = dataclasses.field(
        default_factory=list)       # (generation, seconds) in the window
    peak_bytes: int = 0
    steps_profiled: int = 0
    trace: Optional[trace_mod.Summary] = None
    # pool image -> every answer the window gave for it, (det, n) or None
    answers: Dict[int, list] = dataclasses.field(default_factory=dict)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _peak(device) -> int:
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated())
    return 0


def _host(out) -> Tuple[np.ndarray, np.ndarray]:
    det, n = out
    return np.asarray(det.cpu()), np.asarray(n.cpu())


def _profiled(device, body: Callable[[], int]):
    """Run ``body`` under torch.profiler (CPU and CUDA activity) inside the
    annotation; returns (steps body reports, Summary)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(ANNOTATION):
            steps = body()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = trace_mod.load_events(path)
    finally:
        os.remove(path)
    return steps, trace_mod.summarize(events, ANNOTATION)


@contextlib.contextmanager
def gc_pauses(out: List[Tuple[int, float]]):
    """Record (generation, seconds) of every garbage collection inside."""
    start = {}

    def cb(phase, info):
        if phase == "start":
            start["t"] = time.perf_counter()
        elif "t" in start:
            out.append((info["generation"], time.perf_counter() - start["t"]))
    gc.callbacks.append(cb)
    try:
        yield out
    finally:
        gc.callbacks.remove(cb)


def sample(seeds: inputs.Seeds, n_pool: int, n: int) -> List[int]:
    """The pool images whose answers are compared with the reference."""
    return sorted(seeds.numpy("sample").choice(n_pool, min(n, n_pool),
                                               replace=False).tolist())


def closed(fn, traffic: Dict, pool: np.ndarray, checked: List[int],
           seconds: float, trace: bool, device) -> Window:
    b, p = traffic["batch"], traffic["pool_batches"]
    batches = [pool[i * b:(i + 1) * b] for i in range(p)]
    for i in range(traffic["warmup_batches"]):
        _host(fn(batches[i % p]))
    _sync(device)
    by_batch = {j: [i for i in checked if i // b == j] for j in range(p)}
    answers: Dict[int, list] = {i: [] for i in checked}
    n = 0
    steps, pauses = [], []
    with gc_pauses(pauses):
        t0 = t1 = time.perf_counter()
        while True:
            j = n % p
            det, nd = _host(fn(batches[j]))
            for i in by_batch[j]:
                r = i - j * b
                answers[i].append((det[r].copy(), nd[r].copy())
                                  if r < min(len(det), len(nd)) else None)
            n += 1
            t, t1 = t1, time.perf_counter()
            steps.append(t1 - t)
            if t1 - t0 >= seconds:
                break
    w = Window(seconds=t1 - t0, setup_end=t0, images=n * b, batch=b,
               peak_bytes=_peak(device), answers=answers,
               step_s=steps, gc_pauses=pauses)
    if trace:
        def body():
            for k in range(traffic["trace_steps"]):
                _host(fn(batches[k % p]))
            return traffic["trace_steps"]
        w.steps_profiled, w.trace = _profiled(device, body)
    return w
