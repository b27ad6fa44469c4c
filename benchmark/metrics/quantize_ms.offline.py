"""The input quantizer's torch glue, in ms a batch: device time under the
span ``ayq.quantize``, the port's own kernels and the host-to-device copy
left out (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.stage(run.window, "quantize_ms")
