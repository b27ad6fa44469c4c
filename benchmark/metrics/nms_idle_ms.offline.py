"""The device's idle time while the host is in the span ``ayq.nms`` or a
step of it, in ms a batch: the wait behind q_NMS's syncs
(benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.stage(run.window, "nms_idle_ms")
