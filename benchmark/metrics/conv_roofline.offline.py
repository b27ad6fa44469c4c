"""The conv kernels' share of their roofline, in %: over the profiled
batches, the summed least time of every conv of the forward (the larger of
its bytes at the HBM rate and its operations at the int8 peak, counted from
the graph's shapes and edge dtypes, benchmark/counts.py) over the device
time of the conv kernels."""

# device-side names of the program's conv kernels (runtime/csrc)
CONV_KERNELS = ("conv_wgmma",)


def read(run):
    w = run.window
    t = w.trace.device_s(CONV_KERNELS) if w.trace else 0.0
    if t <= 0:
        return None
    return 100.0 * w.steps_profiled * run.forward_bound_s(w.batch) / t
