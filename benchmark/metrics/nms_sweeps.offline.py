"""q_NMS's Jacobi sweeps a batch: instances of the span ``ayq.nms.sweep``
that start in the profiled window, each a gemv, a compare and a host
sync; the data sets their number (benchmark/spans.py)."""

from benchmark import spans


def read(run):
    return spans.stage(run.window, "nms_sweeps")
