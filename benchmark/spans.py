"""The program's spans in a torch.profiler chrome trace, and a traced run of
a cell broken down by them.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

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
- a blocking runtime call (trace.SYNC_CALLS) belongs to the innermost
  span that encloses it on its thread;
- a span's instances are counted where they start inside the window.

Times are clipped to the profiled window as benchmark/trace.py clips them,
so the device seconds of every span add up to the window's.

The command runs the cell once with ``--trace 1`` as benchmark/run.py
does (run.run_cell), keeps the profiled events and prints, as its last
line, the run's result line with a ``spans`` object added: per batch the
device ms, idle ms and instances of each span, the stage readings, the
forward's glue by node kind, the conv layers beside their bound
(benchmark/counts.py) and the stages' sum against
``torch_ops_ms.offline``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import trace  # noqa: E402

PROGRAM = "ayq"
OUTSIDE = "(outside the program)"
LAUNCH_CATS = frozenset({"cuda_runtime", "cuda_driver"})
# the program's own kernels and the batch's host-to-device copy, as
# metrics/torch_ops_ms.offline.py names them
PORT_KERNELS = ("conv_wgmma", "postconv_kernel", "packed_conv_kernel",
                "sigma_probe_kernel")
H2D = ("Memcpy HtoD",)
CONV = "ayq.forward.conv."
GLUE = ("split", "add", "concat", "maxpool", "upsample", "slab",
        "head_requant")


def is_span(name: str) -> bool:
    return name == PROGRAM or name.startswith(PROGRAM + ".")


def under(name: str, prefix: str) -> bool:
    """``name`` is the span ``prefix`` or nests in it by name."""
    return name == prefix or name.startswith(prefix + ".")


@dataclasses.dataclass
class Spans:
    """What the program's spans show in one profiled window. Seconds."""

    device_s_by_span: Dict[str, Dict[str, float]]  # span -> op -> self
    idle_by_span: Dict[str, float]    # device idle, by the host's span
    span_counts: Dict[str, int]       # instances starting in the window
    syncs_by_span: Dict[str, int]     # blocking runtime calls, by span

    def device_s(self, prefix: str, leave_out=()) -> float:
        """Device seconds under ``prefix`` and the spans nested in it by
        name, without the operations whose name contains any of
        ``leave_out``."""
        return sum(s for span, ops in self.device_s_by_span.items()
                   if under(span, prefix)
                   for op, s in ops.items()
                   if not any(k in op for k in leave_out))

    def idle_s(self, prefix: str) -> float:
        return sum(s for span, s in self.idle_by_span.items()
                   if under(span, prefix))


def window(events: List[dict], annotation: Optional[str] = None
           ) -> Tuple[float, float]:
    """The profiled window in trace microseconds, as trace.summarize takes
    it: the annotation's extent, or the device events' when None."""
    marks = ([e for e in events if e.get("name") == annotation]
             if annotation is not None else
             [e for e in events if e.get("cat") in trace.DEVICE_CATS])
    if not marks:
        raise ValueError(f"no event {annotation!r} in the trace")
    return (min(float(e["ts"]) for e in marks),
            max(float(e["ts"]) + float(e["dur"]) for e in marks))


def _innermost(spans: List[dict], times: List[float]) -> List[str]:
    """For each of the sorted ``times``, the shortest of ``spans`` running
    then, by a sweep over the spans in order of start."""
    order = sorted(spans, key=lambda e: float(e["ts"]))
    active: List[dict] = []
    names, i = [], 0
    for t in times:
        while i < len(order) and float(order[i]["ts"]) <= t:
            active.append(order[i])
            i += 1
        active = [e for e in active if float(e["ts"]) + float(e["dur"]) > t]
        best = min(active, key=lambda e: float(e["dur"]), default=None)
        names.append(best["name"] if best is not None else OUTSIDE)
    return names


def _thread(e: dict):
    return e.get("pid"), e.get("tid")


def attribute(events: List[dict], lo: float, hi: float) -> Spans:
    """Device time, idle time and instances of the program's spans in the
    window [lo, hi) (trace microseconds)."""
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
        if e.get("cat") not in trace.DEVICE_CATS:
            continue
        a = max(float(e["ts"]), lo)
        b = min(float(e["ts"]) + float(e["dur"]), hi)
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
        for span, (_, op, s) in zip(
                _innermost(by_thread.get(thread, []), [q[0] for q in qs]),
                qs):
            device[span][op] += s
    edges = [lo] + [x for ab in trace.union(busy) for x in ab] + [hi]
    gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    idle: Dict[str, float] = defaultdict(float)
    for (a, b), span in zip(gaps, _innermost(spans, [(a + b) / 2
                                                     for a, b in gaps])):
        idle[span] += (b - a) / 1e6
    counts: Dict[str, int] = defaultdict(int)
    for e in spans:
        if lo <= float(e["ts"]) < hi:
            counts[e["name"]] += 1
    calls: Dict[tuple, List[float]] = defaultdict(list)
    for e in events:
        if (e.get("cat") in LAUNCH_CATS and e["name"] in trace.SYNC_CALLS
                and lo <= float(e["ts"]) < hi):
            calls[_thread(e)].append(float(e["ts"]))
    syncs: Dict[str, int] = defaultdict(int)
    for thread, ts in calls.items():
        for span in _innermost(by_thread.get(thread, []), sorted(ts)):
            syncs[span] += 1
    return Spans({k: dict(v) for k, v in device.items()}, dict(idle),
                 dict(counts), dict(syncs))


def breakdown(sp: Spans, summary: trace.Summary, steps: int,
              conv_bound_s: Optional[Dict[str, float]] = None) -> Dict:
    """Per batch of ``steps`` profiled batches: the stage readings, every
    span's device ms (the port's kernels apart), idle ms, instances and
    blocking calls,
    the forward's glue by node kind, the conv layers slowest first beside
    their bound, and the stages' sum against ``torch_ops_ms.offline``
    (``summary``'s reading, the same window). Without device events the
    stages' times read None, as the benchmark's readers do."""
    def ms(s):
        return 1e3 * s / steps

    glue = PORT_KERNELS + H2D
    stages = {
        "quantize_ms": ms(sp.device_s("ayq.quantize", glue)),
        "forward_glue_ms": ms(sp.device_s("ayq.forward", glue)),
        "forward_idle_ms": ms(sp.idle_s("ayq.forward")),
        "decode_ms": ms(sp.device_s("ayq.decode", glue)),
        "nms_ms": ms(sp.device_s("ayq.nms", glue)),
        "nms_sweeps": sp.span_counts.get("ayq.nms.sweep", 0) / steps,
        "nms_idle_ms": ms(sp.idle_s("ayq.nms")),
    }
    rest = sum(s for span, ops in sp.device_s_by_span.items()
               if span in (PROGRAM, OUTSIDE) or under(span, "ayq.ingest")
               for op, s in ops.items() if not any(k in op for k in glue))
    torch_ops = (sum(summary.device_s_by_name.values())
                 - summary.device_s(PORT_KERNELS) - summary.device_s(H2D))
    parts = ("quantize_ms", "forward_glue_ms", "decode_ms", "nms_ms")
    covered = sum(stages[k] for k in parts) + ms(rest)
    if summary.busy_s <= 0:     # no device events: nothing timed
        stages = {k: (v if k == "nms_sweeps" else None)
                  for k, v in stages.items()}
    by_kind = {k: ms(sp.device_s(f"ayq.forward.{k}", glue)) for k in GLUE}
    by_kind["conv wrappers"] = ms(sum(
        s for span, ops in sp.device_s_by_span.items()
        if span.startswith(CONV)
        for op, s in ops.items() if not any(k in op for k in glue)))
    by_kind["forward self"] = ms(sum(
        s for op, s in sp.device_s_by_span.get("ayq.forward", {}).items()
        if not any(k in op for k in glue)))
    convs = []
    for span in sp.device_s_by_span:
        if span.startswith(CONV):
            layer = span[len(CONV):]
            row = {"layer": layer,
                   "kernel_ms": ms(sum(
                       s for op, s in sp.device_s_by_span[span].items()
                       if any(k in op for k in PORT_KERNELS))),
                   "glue_ms": ms(sp.device_s(span, glue))}
            if conv_bound_s is not None and layer in conv_bound_s:
                row["bound_ms"] = 1e3 * conv_bound_s[layer]
            convs.append(row)
    convs.sort(key=lambda r: -r["kernel_ms"])
    names = sorted(set(sp.device_s_by_span) | set(sp.idle_by_span)
                   | set(sp.span_counts) | set(sp.syncs_by_span))
    return {
        "stages": stages,
        "check": {"torch_ops_ms": ms(torch_ops), "stages_and_rest_ms":
                  covered, "rest_ms": ms(rest),
                  "share": covered / ms(torch_ops) if torch_ops else None,
                  "host_syncs": summary.syncs / steps,
                  "syncs_by_span": sum(sp.syncs_by_span.values()) / steps},
        "forward_glue_by_kind_ms": by_kind,
        "conv_layers": convs,
        "by_span": {n: {"device_ms": ms(sum(
                            sp.device_s_by_span.get(n, {}).values())),
                        "port_kernel_ms": ms(sum(
                            s for op, s in sp.device_s_by_span.get(
                                n, {}).items()
                            if any(k in op for k in PORT_KERNELS))),
                        "idle_ms": ms(sp.idle_by_span.get(n, 0.0)),
                        "count": sp.span_counts.get(n, 0) / steps,
                        "syncs": sp.syncs_by_span.get(n, 0) / steps}
                    for n in names},
    }


@contextlib.contextmanager
def _keeping(module, name: str, kept: List):
    """Wrap ``module.name`` for the block so that each call's arguments
    and result are appended to ``kept``."""
    orig = getattr(module, name)

    def wrapper(*args):
        out = orig(*args)
        kept.append((args, out))
        return out
    setattr(module, name, wrapper)
    try:
        yield kept
    finally:
        setattr(module, name, orig)


def traced_run(workload: str, seed: int, seconds: float, device="cuda",
               root: Path = ROOT) -> Dict:
    """benchmark/run.py's traced run of the cell, its result line with the
    span breakdown of its profiled batches under ``spans``."""
    from benchmark import counts, run, spec

    steps = spec.cell(spec.load(root), workload, root).traffic[
        "trace_steps"]
    profiled: List = []
    bounds: List = []
    with _keeping(trace, "summarize", profiled), \
            _keeping(counts, "forward_bound_s", bounds):
        out = run.run_cell(workload, seed, seconds, True, device, root)
    (events, annotation), summary = profiled[-1]
    conv_bound_s = None
    if bounds:
        (graph, size, edge_amax, batch), _ = bounds[-1]
        macs = counts.conv_macs(graph, size)
        by = counts.conv_bytes(graph, size, edge_amax, batch)
        conv_bound_s = {n: counts.bound_s(by[n], batch * macs[n])
                        for n in macs}
    sp = attribute(events, *window(events, annotation))
    result = dict(out["result"])
    checks = result.pop("checks")
    result["spans"] = breakdown(sp, summary, steps, conv_bound_s)
    result["checks"] = checks
    return {"result": result, "notes": out["notes"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("spans: the breakdown reads the card's trace; no CUDA card "
              "visible", file=sys.stderr)
        return 2
    out = traced_run(args.workload, args.seed, args.seconds)
    for line in out["notes"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
