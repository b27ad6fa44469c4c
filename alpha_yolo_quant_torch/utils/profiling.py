"""Tracing and profiling utilities (counterpart of
alpha_yolo_quant_tpu/utils/profiling.py): per-stage wall-clock timers, a
torch.profiler trace of a block (CPU and CUDA activity, written as a
chrome trace), a timer of one call on the card, and the card's name and
power limit.

engine_profile.device_ms is the other timer of the port: it queues the
calls behind a busy wait of the card so that a call shorter than its
launch cost still reads as device time. bench_fn times what a caller
waits for, launch cost included."""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Dict, Optional


def card_name(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    its name from torch where nvidia-smi is absent: written beside every
    number taken on the card."""
    import torch

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else torch.cuda.get_device_name(device)


class StageTimer:
    """Accumulating wall-clock timers keyed by stage name."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = [f"{name:<28} {self.totals[name]*1e3:9.1f} ms "
                 f"(x{self.counts[name]})"
                 for name in sorted(self.totals,
                                    key=lambda n: -self.totals[n])]
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler over the block, CPU and CUDA activity; on exit the
    trace is written to ``log_dir`` as a chrome trace (open it in
    chrome://tracing or Perfetto). Yields the trace file's path, or None
    and does nothing when log_dir is None."""
    if log_dir is None:
        yield None
        return
    import torch

    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


def bench_fn(fn, *args, iters: int = 10, warmup: int = 2,
             device="cuda") -> float:
    """Milliseconds per call of ``fn(*args)``: ``warmup`` calls, then on
    a CUDA device a synchronize and CUDA events around ``iters`` calls;
    on ``device="cpu"`` the host clock around them. A CUDA device without
    a card raises."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_fn: no CUDA device; pass device='cpu' to "
                           "time on the CPU")
    for _ in range(warmup):
        fn(*args)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn(*args)
    t1.record()
    torch.cuda.synchronize(dev)
    return t0.elapsed_time(t1) / iters
