"""The device's idle time while the host is in the span ``ayq.forward`` or
a span in it, in ms a batch: the forward's launch cost the queue does not
hide (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.stage(run.window, "forward_idle_ms")
