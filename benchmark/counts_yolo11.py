"""Operations and bytes of the layers YOLO11 adds, counted from the graph's
shapes as benchmark/counts.py counts the convs: the yardstick of the
depthwise, attention and dense-conv rooflines. ``shapes`` are the cell's
reference's ``graph.edge_shapes(graph, image_size)``.

- A depthwise conv moves its int8 input once, its int8 output once (every
  one requantizes to int8: the SiLU chain, or the plain requant of the
  attention's pe), its 9 int8 taps a channel and its five int32
  per-channel constants (bias and two rescale/shift pairs), for 9
  multiply-accumulates an output element.
- An attention node moves its int8 q, k and v in once and its int8 output
  out once, for 2 * N^2 * (key_dim + head_dim) operations an image and
  head, N the map's pixels: the logits q^T k and the product of their
  exponentials with v (the copy of v it also writes, the pe conv's input,
  and the softmax's table reads are left out).
"""

from __future__ import annotations

import types
from typing import Dict, List, Tuple

from benchmark import counts, spec

Shapes = Dict[str, Tuple[int, int, int]]


def cell_graph(config: Dict):
    """The cell's reference graph and its edge shapes for one image."""
    ref = spec.reference(config)
    size = config["image_size"]
    graph = ref.graph.build_yolov8_graph(ref.config.QuantConfig(
        model=config["model"], k=config["k"],
        full_quant=config["full_quant"], image_size=size,
        koeff_bits=config["koeff_bits"]))
    return graph, ref.graph.edge_shapes(graph, size)


def depthwise_convs(graph) -> List:
    return [n for n in graph.convs() if getattr(n, "groups", 1) > 1]


def depthwise_bound_s(graph, shapes: Shapes, batch: int) -> float:
    """Summed least time of the depthwise convs of one forward over
    ``batch`` images (counts.bound_s of each)."""
    total = 0.0
    for n in depthwise_convs(graph):
        c, h, w = shapes[n.src]
        cout, ho, wo = shapes[n.dst]
        n_bytes = batch * (c * h * w + cout * ho * wo) + cout * (9 + 5 * 4)
        total += counts.bound_s(n_bytes, batch * 9 * cout * ho * wo)
    return total


def conv_bound_s_as_counted(graph, shapes: Shapes, batch: int) -> float:
    """The depthwise convs' share of counts.forward_bound_s: its arithmetic
    (counts.conv_bytes, which reckons 4 output bytes for a conv without
    SiLU) over them alone, their inputs int8 as in every graph that has
    them (the kernel takes no int16)."""
    dw = depthwise_convs(graph)
    only = types.SimpleNamespace(convs=lambda: dw)
    macs = counts.conv_macs(only, shapes)
    by = counts.conv_bytes(only, shapes, {n.src: 127 for n in dw}, batch)
    return sum(counts.bound_s(by[n], batch * macs[n]) for n in macs)


def attention_nodes(graph) -> List:
    return [n for n in graph.nodes if hasattr(n, "key_dim")]


def attention_bound_s(graph, shapes: Shapes, batch: int) -> float:
    """Summed least time of the attention nodes of one forward over
    ``batch`` images: the larger of their bytes at the HBM rate and their
    operations at the int8 peak, node by node."""
    total = 0.0
    for n in attention_nodes(graph):
        c, h, w = shapes[n.src]
        pixels = h * w
        n_bytes = batch * pixels * (c + n.heads * n.head_dim)
        macs = batch * n.heads * pixels ** 2 * (n.key_dim + n.head_dim)
        total += counts.bound_s(n_bytes, macs)
    return total
