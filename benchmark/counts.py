"""Operations and bytes of the convs from the graph's shapes, and the card's
peaks: the yardstick of the roofline and mfu metrics. Counted from shapes
and the plan's edge dtypes, never from a kernel's arguments, so a roofline
reads the same work whatever implements the conv. ``shapes`` are the
cell's reference's ``graph.edge_shapes(graph, image_size)``: edge ->
(C, H, W) of one image (benchmark/spec.py), so one arithmetic serves
every configuration's graph.

A conv moves its input once (int16 on a wide edge, |v| > 127, else int8),
its int8 weights once, its int32 per-channel constants once (bias, and
for a SiLU conv the two rescale/shift pairs) and its output once (int8
after the SiLU requant, the raw int32 accumulator on the head convs).
"""

from __future__ import annotations

from typing import Dict, Tuple

Shapes = Dict[str, Tuple[int, int, int]]

# one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit)
HBM_BPS = 3.35e12
INT8_OPS = 1.979e15


def conv_macs(graph, shapes: Shapes) -> Dict[str, int]:
    """Multiply-accumulates of one image, per conv."""
    return {n.name: n.cin * n.kernel ** 2 * shapes[n.dst][0]
            * shapes[n.dst][1] * shapes[n.dst][2] for n in graph.convs()}


def image_macs(graph, shapes: Shapes) -> int:
    return sum(conv_macs(graph, shapes).values())


def conv_bytes(graph, shapes: Shapes, edge_amax: Dict[str, int],
               batch: int) -> Dict[str, int]:
    """Bytes one launch over ``batch`` images moves, per conv."""
    out: Dict[str, int] = {}
    for n in graph.convs():
        cin, h, w = shapes[n.src]
        cout, ho, wo = shapes[n.dst]
        x = batch * cin * h * w * (2 if edge_amax[n.src] > 127 else 1)
        y = batch * cout * ho * wo * (1 if n.silu else 4)
        consts = cout * 4 * (5 if n.silu else 1)
        out[n.name] = x + y + cout * cin * n.kernel ** 2 + consts
    return out


def bound_s(n_bytes: float, macs: float) -> float:
    """The least time the card could take: bytes at the HBM rate against
    2 * MACs at the dense int8 tensor rate."""
    return max(n_bytes / HBM_BPS, 2 * macs / INT8_OPS)


def forward_bound_s(graph, shapes: Shapes, edge_amax: Dict[str, int],
                    batch: int) -> float:
    """Summed bound of every conv of one forward over ``batch`` images."""
    macs = conv_macs(graph, shapes)
    by = conv_bytes(graph, shapes, edge_amax, batch)
    return sum(bound_s(by[n], batch * macs[n]) for n in macs)
