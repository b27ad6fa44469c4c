"""The whole step's share of the card's dense int8 peak, in %: the window's
images per second times 2 x the conv MACs of one image (counted from the
graph's shapes, benchmark/counts.py) over 1.979e15 operations per second."""

from benchmark.counts import INT8_OPS


def read(run):
    w = run.window
    return 100.0 * w.images / w.seconds * 2 * run.macs_per_image / INT8_OPS
