"""The depthwise conv kernel's share of its roofline, in %: over the
profiled batches, the summed least time of every depthwise conv of the
forward (its int8 bytes at the HBM rate against its operations at the
int8 peak, counted from the graph's shapes, benchmark/counts_yolo11.py)
over the device time of the depthwise kernel. None where the run has no
time of that kernel."""

from benchmark import counts_yolo11

# the device-side name of the program's depthwise kernel (runtime/csrc)
KERNELS = ("dwconv3x3_kernel",)


def read(run):
    w = run.window
    t = w.trace.device_s(KERNELS) if w.trace else 0.0
    if t <= 0:
        return None
    graph, shapes = counts_yolo11.cell_graph(run.cell.config)
    bound = counts_yolo11.depthwise_bound_s(graph, shapes, w.batch)
    return 100.0 * w.steps_profiled * bound / t
