"""The attention kernel's share of its roofline, in %: over the profiled
batches, the summed least time of every attention node of the forward (q,
k, v in and the output out, int8, at the HBM rate against 2 * N^2 *
(key_dim + head_dim) operations an image and head at the int8 peak,
benchmark/counts_yolo11.py) over the device time of the attention
kernel. None where the run has no time of that kernel."""

from benchmark import counts_yolo11

# the device-side name of the program's attention kernel (runtime/csrc)
KERNELS = ("attn_kernel",)


def read(run):
    w = run.window
    t = w.trace.device_s(KERNELS) if w.trace else 0.0
    if t <= 0:
        return None
    graph, shapes = counts_yolo11.cell_graph(run.cell.config)
    bound = counts_yolo11.attention_bound_s(graph, shapes, w.batch)
    return 100.0 * w.steps_profiled * bound / t
