"""Reading a torch.profiler chrome trace: the device's busy time as the union
of its kernel, copy and set intervals, device time by operation, the host
calls that block on the device, the idle gaps of the device by what
the host was doing meanwhile, and the same by the program's spans.

Only complete events (``"ph": "X"``) are read. Device events carry the
categories ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; host events
``cpu_op``, ``cuda_runtime``, ``cuda_driver`` and ``user_annotation``.

The program marks its stages with ``torch.profiler.record_function``
spans named ``ayq``, ``ayq.<stage>``, ``ayq.<stage>.<step>``
(alpha_yolo_quant_torch/utils/profiling.py SPANS); the dotted name is the
nesting. In the chrome trace a span is a ``user_annotation`` event on the
host thread that ran it, and every kernel, copy and set carries the
``args.correlation`` of the runtime call that launched it. So:

- a device event belongs to the innermost span that encloses, on the same
  thread, its launching runtime call (a kernel that runs after its span
  closed still counts to it); one with no such span or launch belongs to
  ``(outside the program)``;
- an idle gap of the device belongs, at its midpoint, to the innermost
  span open then (the program runs a call on one thread), else to
  ``(outside the program)``;
- a blocking runtime call (SYNC_CALLS) belongs to the innermost span that
  encloses it on its thread;
- a span's instances are counted where they start inside the window.

Times are clipped to the window as the other readings clip them, so the
device seconds of every span add up to the window's.
"""

from __future__ import annotations

import dataclasses
import json
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})
HOST_CATS = frozenset({"cpu_op", "cuda_runtime", "cuda_driver"})
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
# CUDA runtime and driver calls that return only once the device has
# reached them: the synchronizes, and the plain (not Async) copies
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize",
    "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D",
    "cuStreamSynchronize", "cuCtxSynchronize", "cuEventSynchronize",
    "cuMemcpyDtoH_v2", "cuMemcpyHtoD_v2"})
IDLE_NOTHING = "(between host ops)"
PROGRAM = "ayq"
OUTSIDE = "(outside the program)"


@dataclasses.dataclass
class Summary:
    """What one profiled span shows. Times in seconds."""

    span_s: float                      # length of the profiled span
    busy_s: float                      # union of device intervals in it
    device_s_by_name: Dict[str, float]  # summed durations per operation
    syncs: int                         # blocking host calls
    idle_by_host_op: Dict[str, float]  # device idle, by the host's op
    # the program's spans in the same window (attribute)
    device_s_by_span: Dict[str, Dict[str, float]]  # span -> op -> self
    idle_by_span: Dict[str, float]     # device idle, by the host's span
    span_counts: Dict[str, int]        # instances starting in the window
    syncs_by_span: Dict[str, int]      # blocking runtime calls, by span

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
    intervals = []
    for e in dev:
        a, b = _clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]), lo, hi)
        if b > a:
            intervals.append((a, b))
            by_name[e["name"]] += (b - a) / 1e6
    busy = union(intervals)
    syncs = sum(1 for e in host if e["name"] in SYNC_CALLS
                and lo <= float(e["ts"]) < hi)
    idle: Dict[str, float] = defaultdict(float)
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    for (a, b), name in zip(gaps, _innermost(
            host, [(a + b) / 2 for a, b in gaps], IDLE_NOTHING)):
        idle[name] += (b - a) / 1e6
    return Summary(span_s=(hi - lo) / 1e6,
                   busy_s=sum(b - a for a, b in busy) / 1e6,
                   device_s_by_name=dict(by_name), syncs=syncs,
                   idle_by_host_op=dict(idle), **attribute(events, lo, hi))


def _innermost(events: List[dict], times: List[float],
               default: str) -> List[str]:
    """For each of the sorted ``times``, the name of the innermost
    (shortest) of ``events`` running then, else ``default``, by a sweep
    over the events in order of start."""
    order = sorted(events, key=lambda e: float(e["ts"]))
    active: List[dict] = []
    names, i = [], 0
    for t in times:
        while i < len(order) and float(order[i]["ts"]) <= t:
            active.append(order[i])
            i += 1
        active = [e for e in active if float(e["ts"]) + float(e["dur"]) > t]
        best = min(active, key=lambda e: float(e["dur"]), default=None)
        names.append(best["name"] if best is not None else default)
    return names


def is_span(name: str) -> bool:
    return name == PROGRAM or name.startswith(PROGRAM + ".")


def _thread(e: dict):
    return e.get("pid"), e.get("tid")


def attribute(events: List[dict], lo: float, hi: float) -> Dict[str, dict]:
    """Summary's span fields in the window [lo, hi) (trace microseconds):
    device time, idle time, instances and blocking calls of the program's
    spans."""
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and is_span(e.get("name", ""))]
    by_thread: Dict[tuple, List[dict]] = defaultdict(list)
    for e in spans:
        by_thread[_thread(e)].append(e)
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    device: Dict[str, Dict[str, float]] = defaultdict(
        lambda: defaultdict(float))
    queries: Dict[tuple, List[Tuple[float, str, float]]] = defaultdict(list)
    busy = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = _clip(float(e["ts"]), float(e["ts"]) + float(e["dur"]), lo, hi)
        if b <= a:
            continue
        busy.append((a, b))
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is None:
            device[OUTSIDE][e["name"]] += (b - a) / 1e6
        else:
            queries[_thread(launch)].append(
                (float(launch["ts"]), e["name"], (b - a) / 1e6))
    for thread, qs in queries.items():
        qs.sort()
        for span, (_, op, s) in zip(_innermost(
                by_thread.get(thread, []), [q[0] for q in qs], OUTSIDE), qs):
            device[span][op] += s
    edges = [lo] + [x for ab in union(busy) for x in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle: Dict[str, float] = defaultdict(float)
    for (a, b), span in zip(gaps, _innermost(
            spans, [(a + b) / 2 for a, b in gaps], OUTSIDE)):
        idle[span] += (b - a) / 1e6
    counts: Dict[str, int] = defaultdict(int)
    for e in spans:
        if lo <= float(e["ts"]) < hi:
            counts[e["name"]] += 1
    calls: Dict[tuple, List[float]] = defaultdict(list)
    for e in events:
        if (e.get("cat") in LAUNCH_CATS and e["name"] in SYNC_CALLS
                and lo <= float(e["ts"]) < hi):
            calls[_thread(e)].append(float(e["ts"]))
    syncs: Dict[str, int] = defaultdict(int)
    for thread, ts in calls.items():
        for span in _innermost(by_thread.get(thread, []), sorted(ts),
                               OUTSIDE):
            syncs[span] += 1
    return {"device_s_by_span": {k: dict(v) for k, v in device.items()},
            "idle_by_span": dict(idle), "span_counts": dict(counts),
            "syncs_by_span": dict(syncs)}
