"""Share of the profiled batches' span, in %, in which no kernel, copy or
set ran on the device."""


def read(run):
    tr = run.window.trace
    if not tr or tr.span_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.span_s)
