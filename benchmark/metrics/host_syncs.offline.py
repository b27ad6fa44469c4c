"""CUDA runtime and driver calls per batch that block the host until the
device reaches them (stream, device and event synchronizes, plain copies),
from the profiler's runtime events (benchmark/trace.py SYNC_CALLS)."""


def read(run):
    w = run.window
    if not w.trace or not w.steps_profiled or w.trace.busy_s <= 0:
        return None
    return w.trace.syncs / w.steps_profiled
