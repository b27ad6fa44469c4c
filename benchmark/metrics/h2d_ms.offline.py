"""Device milliseconds per batch of the host-to-device copies: the uint8
batch handed from host memory, which the pipeline's ``fn`` copies to the
card (pageable, as ``serve`` hands it)."""

H2D = ("Memcpy HtoD",)


def read(run):
    w = run.window
    if not w.trace or not w.steps_profiled:
        return None
    t = w.trace.device_s(H2D)
    return 1e3 * t / w.steps_profiled if t > 0 else None
