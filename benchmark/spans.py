"""The program's spans in a torch.profiler chrome trace, and a traced run of
a cell broken down by them.

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>

The program marks its stages with ``torch.profiler.record_function``
spans named ``ayq``, ``ayq.<stage>``, ``ayq.<stage>.<step>``; the dotted
name is the nesting. ``trace.summarize`` attributes the device time, idle
time, instances and blocking calls of a profiled window to them (the
rules are in benchmark/trace.py) and keeps them in its Summary. The stage
readings (``stages``) and the breakdown read them there, and so do the
metrics ``benchmark/metrics/<stage>.offline.py`` (``stage``), so the
result line and the breakdown cannot disagree.

The command runs the cell once with ``--trace 1`` as benchmark/run.py
does (run.run_cell) and prints, as its last line, the run's result line
with a ``spans`` object added: per batch the device ms, idle ms and
instances of each span, the stage readings, the forward's glue by node
kind, the conv layers beside their bound (benchmark/counts.py) and the
stages' sum against ``torch_ops_ms.offline``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import trace  # noqa: E402

# the program's own kernels and the batch's host-to-device copy, as
# metrics/torch_ops_ms.offline.py names them
PORT_KERNELS = ("conv_wgmma", "postconv_kernel", "packed_conv_kernel",
                "sigma_probe_kernel")
H2D = ("Memcpy HtoD",)
NOT_GLUE = PORT_KERNELS + H2D
CONV = "ayq.forward.conv."
GLUE = ("split", "add", "concat", "maxpool", "upsample", "slab",
        "head_requant")


def under(name: str, prefix: str) -> bool:
    """``name`` is the span ``prefix`` or nests in it by name."""
    return name == prefix or name.startswith(prefix + ".")


def device_s(summary: trace.Summary, prefix: str, leave_out=()) -> float:
    """Device seconds under ``prefix`` and the spans nested in it by name,
    without the operations whose name contains any of ``leave_out``."""
    return sum(s for span, ops in summary.device_s_by_span.items()
               if under(span, prefix)
               for op, s in ops.items()
               if not any(k in op for k in leave_out))


def idle_s(summary: trace.Summary, prefix: str) -> float:
    """Device idle seconds while the host was under ``prefix`` or a span
    nested in it."""
    return sum(s for span, s in summary.idle_by_span.items()
               if under(span, prefix))


def stages(summary: trace.Summary, steps: int) -> Dict[str, float]:
    """The stage readings a batch over ``steps`` profiled batches: the
    ingest's device plus idle ms, the torch glue's device ms under the
    input quantizer, the forward, decode and q_NMS (the port's kernels and
    the H2D copy left out), the idle ms of the forward and of q_NMS, and
    the q_NMS sweeps."""
    def ms(s):
        return 1e3 * s / steps

    return {
        "ingest_ms": ms(device_s(summary, "ayq.ingest")
                        + idle_s(summary, "ayq.ingest")),
        "quantize_ms": ms(device_s(summary, "ayq.quantize", NOT_GLUE)),
        "forward_glue_ms": ms(device_s(summary, "ayq.forward", NOT_GLUE)),
        "forward_idle_ms": ms(idle_s(summary, "ayq.forward")),
        "decode_ms": ms(device_s(summary, "ayq.decode", NOT_GLUE)),
        "nms_ms": ms(device_s(summary, "ayq.nms", NOT_GLUE)),
        "nms_sweeps": summary.span_counts.get("ayq.nms.sweep", 0) / steps,
        "nms_idle_ms": ms(idle_s(summary, "ayq.nms")),
    }


def stage(window, name: str) -> Optional[float]:
    """One of ``stages`` for a metric's reader, from a run's
    loops.Window; None where the run has no device events."""
    tr = window.trace
    if not tr or not window.steps_profiled or tr.busy_s <= 0:
        return None
    return stages(tr, window.steps_profiled)[name]


def breakdown(summary: trace.Summary, steps: int,
              conv_bound_s: Optional[Dict[str, float]] = None) -> Dict:
    """Per batch of ``steps`` profiled batches: the stage readings, every
    span's device ms (the port's kernels apart), idle ms, instances and
    blocking calls, the forward's glue by node kind, the conv layers
    slowest first beside their bound, and the stages' sum against
    ``torch_ops_ms.offline`` (``summary``'s reading, the same window).
    Without device events the stages' times read None, as the benchmark's
    readers do."""
    def ms(s):
        return 1e3 * s / steps

    st = stages(summary, steps)
    rest = sum(s for span, ops in summary.device_s_by_span.items()
               if span in (trace.PROGRAM, trace.OUTSIDE)
               or under(span, "ayq.ingest")
               for op, s in ops.items() if not any(k in op for k in NOT_GLUE))
    torch_ops = (sum(summary.device_s_by_name.values())
                 - summary.device_s(PORT_KERNELS) - summary.device_s(H2D))
    parts = ("quantize_ms", "forward_glue_ms", "decode_ms", "nms_ms")
    covered = sum(st[k] for k in parts) + ms(rest)
    if summary.busy_s <= 0:     # no device events: nothing timed
        st = {k: (v if k == "nms_sweeps" else None) for k, v in st.items()}
    by_kind = {k: ms(device_s(summary, f"ayq.forward.{k}", NOT_GLUE))
               for k in GLUE}
    by_kind["conv wrappers"] = ms(sum(
        s for span, ops in summary.device_s_by_span.items()
        if span.startswith(CONV)
        for op, s in ops.items() if not any(k in op for k in NOT_GLUE)))
    by_kind["forward self"] = ms(sum(
        s for op, s in summary.device_s_by_span.get("ayq.forward", {}).items()
        if not any(k in op for k in NOT_GLUE)))
    convs = []
    for span, ops in summary.device_s_by_span.items():
        if span.startswith(CONV):
            layer = span[len(CONV):]
            row = {"layer": layer,
                   "kernel_ms": ms(sum(s for op, s in ops.items()
                                       if any(k in op for k in PORT_KERNELS))),
                   "glue_ms": ms(device_s(summary, span, NOT_GLUE))}
            if conv_bound_s is not None and layer in conv_bound_s:
                row["bound_ms"] = 1e3 * conv_bound_s[layer]
            convs.append(row)
    convs.sort(key=lambda r: -r["kernel_ms"])
    names = sorted(set(summary.device_s_by_span) | set(summary.idle_by_span)
                   | set(summary.span_counts) | set(summary.syncs_by_span))
    return {
        "stages": st,
        "check": {"torch_ops_ms": ms(torch_ops), "stages_and_rest_ms":
                  covered, "rest_ms": ms(rest),
                  "share": covered / ms(torch_ops) if torch_ops else None,
                  "host_syncs": summary.syncs / steps,
                  "syncs_by_span":
                      sum(summary.syncs_by_span.values()) / steps},
        "forward_glue_by_kind_ms": by_kind,
        "conv_layers": convs,
        "by_span": {n: {"device_ms": ms(sum(
                            summary.device_s_by_span.get(n, {}).values())),
                        "port_kernel_ms": ms(sum(
                            s for op, s in summary.device_s_by_span.get(
                                n, {}).items()
                            if any(k in op for k in PORT_KERNELS))),
                        "idle_ms": ms(summary.idle_by_span.get(n, 0.0)),
                        "count": summary.span_counts.get(n, 0) / steps,
                        "syncs": summary.syncs_by_span.get(n, 0) / steps}
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
    _, summary = profiled[-1]
    conv_bound_s = None
    if bounds:
        (graph, shapes, edge_amax, batch), _ = bounds[-1]
        macs = counts.conv_macs(graph, shapes)
        by = counts.conv_bytes(graph, shapes, edge_amax, batch)
        conv_bound_s = {n: counts.bound_s(by[n], batch * macs[n])
                        for n in macs}
    result = dict(out["result"])
    checks = result.pop("checks")
    result["spans"] = breakdown(summary, steps, conv_bound_s)
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
