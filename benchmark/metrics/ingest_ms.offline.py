"""The input ingest, in ms a batch: device time under the span
``ayq.ingest`` (the staged chunks' host-to-device copies among it) plus
the device's idle time while the host is in it (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.stage(run.window, "ingest_ms")
