"""The forward's torch glue, in ms a batch: device time under the span
``ayq.forward`` and the spans in it (requants, concats, residual adds,
splits, pools, upsamples, layout copies), the port's own kernels left out
(benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.stage(run.window, "forward_glue_ms")
