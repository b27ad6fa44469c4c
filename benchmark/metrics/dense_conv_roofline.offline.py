"""The dense conv kernels' share of their roofline, in %:
conv_roofline.offline's arithmetic (benchmark/counts.py) over the convs
whose groups are 1, against the device time of the conv kernels: the
summed bound of every conv of the forward less that of its depthwise
convs, as counts.py counts them (benchmark/counts_yolo11.py), over the
time of ``conv_wgmma``. None where the run has no time of that kernel."""

from benchmark import counts_yolo11

# device-side names of the program's dense conv kernels (runtime/csrc)
CONV_KERNELS = ("conv_wgmma",)


def read(run):
    w = run.window
    t = w.trace.device_s(CONV_KERNELS) if w.trace else 0.0
    if t <= 0:
        return None
    graph, shapes = counts_yolo11.cell_graph(run.cell.config)
    dense = run.forward_bound_s(w.batch) \
        - counts_yolo11.conv_bound_s_as_counted(graph, shapes, w.batch)
    return 100.0 * w.steps_profiled * dense / t
