"""Reading a torch.profiler chrome trace: the device's busy time as the union
of its kernel, copy and set intervals, device time by operation, the host
calls that block on the device, and the idle gaps of the device by what
the host was doing meanwhile.

Only complete events (``"ph": "X"``) are read. Device events carry the
categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; host events
``cpu_op``, ``cuda_runtime``, ``cuda_driver`` and ``user_annotation``.
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "cuda_runtime", "cuda_driver"})
# CUDA runtime and driver calls that return only once the device has
# reached them: the synchronizes, and the plain (not Async) copies
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize",
    "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
    "cuMemcpyDtoH_v2", "cuMemcpyHtoD_v2"})
IDLE_NOTHING = "(between host ops)"


@dataclasses.dataclass
class Summary:
    """What one profiled span shows. Times in seconds."""

    span_s: float                      # length of the profiled span
    busy_s: float                      # union of device intervals in it
    device_s_by_name: Dict[str, float]  # summed durations per operation
    syncs: int                         # blocking host calls
    idle_by_host_op: Dict[str, float]  # device idle, by the host's op

    def device_s(self, names) -> float:
        """Device seconds of the operations whose name contains any of
        ``names``."""
        return sum(s for n, s in self.device_s_by_name.items()
                   if any(k in n for k in names))

    def top(self, d: Dict[str, float], n: int = 10) -> List[list]:
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:n]]


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(a: float, b: float, lo: float, hi: float):
    return max(a, lo), min(b, hi)


def summarize(events: List[dict], annotation: Optional[str] = None
              ) -> Summary:
    """Summary of the span covered by the user annotation named
    ``annotation`` (the whole trace's device events when None)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    if annotation is not None:
        marks = [e for e in events if e.get("name") == annotation]
        if not marks:
            raise ValueError(f"no event {annotation!r} in the trace")
        lo = min(float(e["ts"]) for e in marks)
        hi = max(float(e["ts"]) + float(e["dur"]) for e in marks)
    else:
        lo = min(float(e["ts"]) for e in dev)
        hi = max(float(e["ts"]) + float(e["dur"]) for e in dev)
    by_name: Dict[str, float] = defaultdict(float)
    spans = []
    for e in dev:
        a, b = _clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]), lo, hi)
        if b > a:
            spans.append((a, b))
            by_name[e["name"]] += (b - a) / 1e6
    busy = union(spans)
    syncs = sum(1 for e in host if e["name"] in SYNC_CALLS
                and lo <= float(e["ts"]) < hi)
    idle: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    for (a, b), name in zip(gaps, _host_ops_at(host, [(a + b) / 2
                                                     for a, b in gaps])):
        idle[name] += (b - a) / 1e6
    return Summary(span_s=(hi - lo) / 1e6,
                   busy_s=sum(b - a for a, b in busy) / 1e6,
                   device_s_by_name=dict(by_name), syncs=syncs,
                   idle_by_host_op=dict(idle))


def _host_ops_at(host: List[dict], times: List[float]) -> List[str]:
    """For each of the sorted ``times``, the innermost (shortest) host
    event running then, by a sweep over the events in order of start."""
    order = sorted(host, key=lambda e: float(e["ts"]))
    active: List[dict] = []
    names, i = [], 0
    for t in times:
        while i < len(order) and float(order[i]["ts"]) <= t:
            active.append(order[i])
            i += 1
        active = [e for e in active if float(e["ts"]) + float(e["dur"]) > t]
        best = min(active, key=lambda e: float(e["dur"]), default=None)
        names.append(best["name"] if best is not None else IDLE_NOTHING)
    return names
