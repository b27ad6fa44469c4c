"""Device milliseconds per batch of every kernel, copy and set that is not
one of the program's own named kernels and not the host-to-device copy of
the batch (h2d_ms.offline reads that): the torch glue (requants, casts,
device copies, concats, decode, q_NMS)."""

PORT_KERNELS = ("conv_wgmma", "postconv_kernel", "packed_conv_kernel",
                "sigma_probe_kernel")
H2D = ("Memcpy HtoD",)


def read(run):
    w = run.window
    if not w.trace or not w.steps_profiled or w.trace.busy_s <= 0:
        return None
    tr = w.trace
    other = (sum(tr.device_s_by_name.values()) - tr.device_s(PORT_KERNELS)
             - tr.device_s(H2D))
    return 1e3 * other / w.steps_profiled
