"""Decode's torch glue, in ms a batch: device time under the span
``ayq.decode`` (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.stage(run.window, "decode_ms")
