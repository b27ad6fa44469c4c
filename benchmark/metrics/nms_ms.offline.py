"""q_NMS's torch glue, in ms a batch: device time under the span ``ayq.nms``
and its steps (select, suppress, sweeps, compact; benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.stage(run.window, "nms_ms")
