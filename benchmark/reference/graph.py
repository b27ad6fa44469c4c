"""Declarative graph IR for the YOLOv8 detection network.

The reference re-declares the same ~450-line architecture in six different
files (stage_1.py:285-764, stage_2.py:254-679, stage_4.py:251-945,
stage_6.py:185-649, stage_7.py:243-745, stage_8_torch.py:283-961). Here the
graph exists ONCE as a typed op list; every consumer — float forward,
calibration, the quantized interpreter, the slab planner, and the exporters
— walks the same IR. The scale plan of the quantized pipeline (which tensor's
scale wins at every residual/concat) is explicit data instead of being
encoded positionally in 600-line scripts.

Naming stays compatible with the reference so calibration files, weight
pickles and Verilog artifacts match:
  * ConvNode.name  -> stage_6 layer names ('Conv_P1', 'C2F_2_conv_0', ...)
  * ConvNode.key   -> state-dict prefixes ('conv0.0', 'cf2_bottle_0.2', ...)
  * ConvNode.tap   -> stage_4 calibration tap names ('conv_p1', ...)

The benchmark's frozen copy of alpha_yolo_quant_torch/models/graph.py,
logic unchanged: the plain reference imports nothing of the program.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

from benchmark.reference.config import QuantConfig


@dataclasses.dataclass(frozen=True)
class ConvNode:
    """Conv (+ optional fused-SiLU) node.

    tap: this conv's own calibration tap — the max-abs of its PRE-activation
      output is recorded under this name (reference stage_4.py:481-910).
    out_tap: the tap whose calibrated value the quantized pipeline uses to
      requantize this node's SiLU output (the `a_silu` argument threaded
      through reference stage_6.py; by the reference's convention it is the
      *next* conv's own tap).
    """

    name: str
    key: str
    src: str
    dst: str
    cin: int
    cout: int
    kernel: int = 1
    stride: int = 1
    padding: int = 0
    silu: bool = True
    tap: Optional[str] = None
    out_tap: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class SplitNode:
    """Channel-halves split (reference stage_6.py:59-69)."""

    src: str
    dst1: str
    dst2: str


@dataclasses.dataclass(frozen=True)
class ResidualAddNode:
    """Bottleneck shortcut: requantize `src` to `base`'s scale, then integer
    add (reference stage_6.py:221-228). `label` names the export artifacts
    ('<label>_RESCALE' / '<label>_SUMM')."""

    src: str
    base: str
    dst: str
    label: str


@dataclasses.dataclass(frozen=True)
class ConcatNode:
    """Channel concat. Every input whose edge differs from `scale_from` is
    requantized to `scale_from`'s scale first (reference stage_6.py:397-403,
    438-444, 478-481, 515-518). `label` names export artifacts.

    `declared_scale_from`: the full-quant reference requantizes the fresh
    conv's data into the OTHER participant's scale but never updates the
    scale variable it passes downstream (stage_6_full_quant.py:530-531,
    567-568 then :541/:579 reuse the stale ``scale_result_3``) — so the
    DECLARED output scale can differ from the actual data scale. None =
    consistent (declared == scale_from)."""

    srcs: Tuple[str, ...]
    scale_from: str
    dst: str
    label: str
    declared_scale_from: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class MaxPoolNode:
    """Integer max-pool, scale unchanged (reference utils/maxpooling_batch.py:
    27-103 — max over the window clipped to the valid region). `label` names
    the export artifact ('MAXPOOLING_X1'...)."""

    src: str
    dst: str
    label: str
    kernel: int = 5
    stride: int = 1
    padding: int = 2


@dataclasses.dataclass(frozen=True)
class UpsampleNode:
    """Nearest-neighbour 2x upsample, scale unchanged (reference
    stage_6.py:72-73)."""

    src: str
    dst: str
    factor: int = 2


Node = Union[ConvNode, SplitNode, ResidualAddNode, ConcatNode,
             MaxPoolNode, UpsampleNode]


@dataclasses.dataclass(frozen=True)
class Graph:
    """The full network: ordered nodes + named head output edges.

    outputs maps role -> edge for the six detect-head outputs:
      ('p3'|'p4'|'p5') x ('box'|'cls'), strides 8/16/32.
    """

    cfg: QuantConfig
    nodes: Tuple[Node, ...]
    input_edge: str
    outputs: Dict[str, str]

    def convs(self) -> List[ConvNode]:
        return [n for n in self.nodes if isinstance(n, ConvNode)]

    def conv_by_name(self, name: str) -> ConvNode:
        for n in self.convs():
            if n.name == name:
                return n
        raise KeyError(name)

    @property
    def param_keys(self) -> List[str]:
        """All conv param keys in graph order, plus 'dfl'."""
        return [c.key for c in self.convs()] + ["dfl"]


def _c(x: float) -> int:
    return int(x)


# Reference tap names for the C2F bottleneck chains at depth 0.33
# (stage_4.py:481-910). Deeper scales have no reference naming; generated
# names are used instead (see _bottle_taps).
_REF_BOTTLE_TAPS = {
    "C2F_2": ["conv_b_0_c2f", "conv_b_1_c2f"],
    "C2F_4": ["conv_b1_c2f", "conv_b2_c2f", "conv_b3_c2f", "conv_b4_c2f"],
    "C2F_6": ["cf2_bconv_4", "cf2_bconv1_4", "cf2_bconv_5", "cf2_bconv1_5"],
    "C2F_8": ["cf2_bottle_6", "cf2_bottle_61"],
    "C2F_12": ["cf2_conv_80", "cf2_conv_81"],
    "C2F_15": ["cf2_bottle_8", "cf2_bottle_81"],
    "C2F_18": ["cf2_bottle_9", "cf2_bottle_90"],
    "C2F_21": ["cf2_bottle_10", "cf2_bottle_101"],
}


def build_yolov8_graph(cfg: QuantConfig) -> Graph:
    """Build the YOLOv8 graph for the configured scale (n/s/m/l/x).

    Channel arithmetic per reference stage_1.py:621-766; layer/tap wiring per
    reference stage_6.py:185-649 (transcribed, not imported). For n/s
    (depth 0.33) every layer/tap/key name matches the reference exactly
    (export/calibration parity depends on it). m/l/x are an extension: the
    reference defines no naming for the extra bottleneck convs, so their
    taps are generated ('c2f_<block>_b<j>') and their state-dict keys follow
    the reference's own index formulas (stage_1.py:628-744), which remain
    well-defined at any depth.
    """
    w, r, d = cfg.width, cfg.ratio, cfg.depth
    # bottlenecks per block (reference stage_1.py n_2/n_4/...; ultralytics
    # max(round(n*d), 1))
    n2 = max(int(round(3 * d)), 1)
    n4 = max(int(round(6 * d)), 1)
    n6 = max(int(round(6 * d)), 1)
    n8 = max(int(round(3 * d)), 1)
    nn = max(int(round(3 * d)), 1)
    # state-dict bottleneck indices, the reference's exact (quirky) formulas:
    # C2F_4 starts at n_2+1 (stage_1.py:638 skips an index), the later
    # blocks at the cumulative count including their own
    b2 = list(range(n2))
    b4 = list(range(n2 + 1, n4 + n2 + 1))
    b6 = list(range(n4 + n2 + 1, n6 + n4 + n2 + 1))
    b8 = [n8 + n6 + n4 + n2 + i for i in range(n8)]
    s12 = nn + n8 + n6 + n4 + n2
    b12 = [s12 + i for i in range(nn)]
    b15 = [s12 + nn + i for i in range(nn)]
    b18 = [s12 + 2 * nn + i for i in range(nn)]
    b21 = [s12 + 3 * nn + i for i in range(nn)]

    def _bottle_taps(block: str, n: int) -> List[str]:
        """2n bottleneck-conv tap names for one C2F block."""
        if d == 0.33:
            return _REF_BOTTLE_TAPS[block]
        return [f"{block.lower()}_b{j}" for j in range(2 * n)]

    c1, c2, c3, c4 = _c(64 * w), _c(128 * w), _c(256 * w), _c(512 * w)
    c5 = _c(512 * w * r)
    ch_cls = cfg.detect_cls_channels
    # box-branch hidden width: the reference hardcodes 64 (stage_1.py:
    # detect_0) — which equals the ultralytics formula max(16, ch[0]//4,
    # 4*reg_max) for n/s/m/l; yolov8x (P3=320ch) needs 80
    ch_box = max(64, c3 // 4)

    nodes: List[Node] = []

    def conv(name, key, src, dst, cin, cout, k, s, p, silu, tap, out_tap):
        nodes.append(ConvNode(name=name, key=key, src=src, dst=dst, cin=cin,
                              cout=cout, kernel=k, stride=s, padding=p,
                              silu=silu, tap=tap, out_tap=out_tap))

    def c2f(prefix, bottle_idx, src, dst, cin, cmid, cout, taps,
            shortcut: bool, label_prefix: str):
        """One C2F block. `taps` is the chain of tap names:
        [own, b0, b1, ..., b_{2n-1}, last, next] — own tap of conv_0, the 2n
        bottleneck conv taps, conv_1's own tap, and the consumer tap.
        cmid = cout_of_conv0; bottleneck width = cmid // 2.
        """
        cb = cmid // 2
        n = len(bottle_idx)
        conv(f"{prefix}_conv_0", f"cf2_conv_{taps['conv0_key_i']}.0", src,
             f"{dst}.c0", cin, cmid, 1, 1, 0, True, taps["own"], taps["b"][0])
        nodes.append(SplitNode(f"{dst}.c0", f"{dst}.x1", f"{dst}.x2"))
        parts = [f"{dst}.x1", f"{dst}.x2"]
        prev = f"{dst}.x2"
        for j, bi in enumerate(bottle_idx):
            t0, t1, t2 = taps["b"][2 * j], taps["b"][2 * j + 1], (
                taps["b"][2 * j + 2] if 2 * j + 2 < len(taps["b"])
                else taps["last"])
            conv(f"{prefix}_bottle_{2*j}", f"cf2_bottle_{bi}.0", prev,
                 f"{dst}.b{j}.0", cb, cb, 3, 1, 1, True, t0, t1)
            conv(f"{prefix}_bottle_{2*j+1}", f"cf2_bottle_{bi}.2",
                 f"{dst}.b{j}.0", f"{dst}.b{j}.1", cb, cb, 3, 1, 1, True,
                 t1, t2)
            if shortcut:
                nodes.append(ResidualAddNode(
                    src=f"{dst}.b{j}.1", base=prev, dst=f"{dst}.s{j}",
                    label=f"{prefix}_bottle_{2*j+1}"))
                prev = f"{dst}.s{j}"
            else:
                # Neck C2F: the bottleneck output is requantized to the block
                # scale at concat time (no add). Model as a 1-input requant
                # via the concat's scale_from.
                prev = f"{dst}.b{j}.1"
            parts.append(prev)
        nodes.append(ConcatNode(srcs=tuple(parts), scale_from=f"{dst}.c0",
                                dst=f"{dst}.cat",
                                label=f"{prefix}_bottle_{2*n-1}"))
        conv(f"{prefix}_conv_1", f"cf2_conv_{taps['conv1_key_i']}.0",
             f"{dst}.cat", dst, cmid // 2 * (2 + n), cout, 1, 1, 0, True,
             taps["last"], taps["next"])

    # ---------------- backbone ----------------
    conv("Conv_P1", "conv0.0", "image", "p1", 3, c1, 3, 2, 1, True,
         "conv_p1", "conv_p2")
    conv("Conv_P2", "conv1.0", "p1", "p2", c1, c2, 3, 2, 1, True,
         "conv_p2", "conv_0_c2f")
    c2f("C2F_2", b2, "p2", "c2f2", c2, c2, c2,
        dict(conv0_key_i=0, conv1_key_i=1, own="conv_0_c2f",
             b=_bottle_taps("C2F_2", n2), last="conv_b_2_c2f",
             next="conv_p3"),
        shortcut=True, label_prefix="C2F_2")
    conv("Conv_P3", "conv3.0", "c2f2", "p3", c2, c3, 3, 2, 1, True,
         "conv_p3", "conv_2_c2f")
    c2f("C2F_4", b4, "p3", "c2f4", c3, c3, c3,
        dict(conv0_key_i=2, conv1_key_i=3, own="conv_2_c2f",
             b=_bottle_taps("C2F_4", n4),
             last="conv_b5_c2f", next="conv_5"),
        shortcut=True, label_prefix="C2F_4")
    conv("Conv_P4", "conv5.0", "c2f4", "p4", c3, c4, 3, 2, 1, True,
         "conv_5", "cf2_conv_4")
    c2f("C2F_6", b6, "p4", "c2f6", c4, c4, c4,
        dict(conv0_key_i=4, conv1_key_i=5, own="cf2_conv_4",
             b=_bottle_taps("C2F_6", n6),
             last="cf2_6_conv_last", next="conv7"),
        shortcut=True, label_prefix="C2F_6")
    conv("Conv_P5", "conv7.0", "c2f6", "p5", c4, c5, 3, 2, 1, True,
         "conv7", "cf2_conv_6")
    c2f("C2F_8", b8, "p5", "c2f8", c5, c5, c5,
        dict(conv0_key_i=6, conv1_key_i=7, own="cf2_conv_6",
             b=_bottle_taps("C2F_8", n8), last="cf2_conv_7",
             next="sppf_conv_1"),
        shortcut=True, label_prefix="C2F_8")

    # ---------------- SPPF ----------------
    conv("SPPF_conv_0", "sppf_conv_1.0", "c2f8", "sppf.c0", c5, c5 // 2,
         1, 1, 0, True, "sppf_conv_1", "sppf_conv_2")
    nodes.append(MaxPoolNode("sppf.c0", "sppf.m1", "MAXPOOLING_X1"))
    nodes.append(MaxPoolNode("sppf.m1", "sppf.m2", "MAXPOOLING_X2"))
    nodes.append(MaxPoolNode("sppf.m2", "sppf.m3", "MAXPOOLING_X3"))
    nodes.append(ConcatNode(("sppf.c0", "sppf.m1", "sppf.m2", "sppf.m3"),
                            scale_from="sppf.c0", dst="sppf.cat",
                            label="SPPF_POOLCAT"))
    conv("SPPF_conv_1", "sppf_conv_2.0", "sppf.cat", "sppf", c5 * 2, c5,
         1, 1, 0, True, "sppf_conv_2", "cf2_conv_8")

    # ---------------- neck (FPN up) ----------------
    nodes.append(UpsampleNode("sppf", "up10"))
    # Partial-quant: upsampled SPPF requantized into C2F_6's scale
    # (reference stage_6.py CONCAT_2X3). Order: (upsampled, skip).
    nodes.append(ConcatNode(("up10", "c2f6"), scale_from="c2f6",
                            dst="cat_2x3", label="CONCAT_2X3"))
    c2f("C2F_12", b12, "cat_2x3", "c2f12", c4 + c5, c4, c4,
        dict(conv0_key_i=8, conv1_key_i=9, own="cf2_conv_8",
             b=_bottle_taps("C2F_12", nn), last="cf2_conv_9",
             next="cf2_conv_10"),
        shortcut=False, label_prefix="C2F_12")
    nodes.append(UpsampleNode("c2f12", "up13"))
    nodes.append(ConcatNode(("up13", "c2f4"), scale_from="c2f4",
                            dst="cat_1x3", label="CONCAT_1X3"))
    c2f("C2F_15", b15, "cat_1x3", "c2f15", c3 + c4, c3, c3,
        dict(conv0_key_i=10, conv1_key_i=11, own="cf2_conv_10",
             b=_bottle_taps("C2F_15", nn), last="cf2_conv_11",
             next="conv8"),
        shortcut=False, label_prefix="C2F_15")

    # ---------------- neck (PAN down) ----------------
    conv("Conv_16", "conv8.0", "c2f15", "p3d", c3, c3, 3, 2, 1, True,
         "conv8", "cf2_conv_12")
    # Scale-winner differs between the partial- and full-quant pipelines
    # (reference stage_6.py vs stage_6_full_quant.py CONCAT_3X4): partial
    # requantizes the skip into the fresh conv's scale; full-quant the
    # opposite. Concat ORDER is identical.
    # stage8_concat_flow: the deployed full-quant runtime uses the
    # PARTIAL direction at both PAN-down seams (see QuantConfig)
    quirk_6b = cfg.full_quant and not cfg.stage8_concat_flow
    sf_3x4 = "c2f12" if quirk_6b else "p3d"
    nodes.append(ConcatNode(
        ("p3d", "c2f12"), scale_from=sf_3x4, dst="cat_3x4",
        label="CONCAT_3X4",
        # full-quant stale-scale quirk: data lands in c2f12's scale but
        # C2F_18_conv_0 consumes it at the fresh conv's scale
        # (stage_6_full_quant.py:530-541)
        declared_scale_from="p3d" if quirk_6b else None))
    c2f("C2F_18", b18, "cat_3x4", "c2f18", c3 + c4, c4, c4,
        dict(conv0_key_i=12, conv1_key_i=13, own="cf2_conv_12",
             b=_bottle_taps("C2F_18", nn), last="cf2_conv_13",
             next="conv9"),
        shortcut=False, label_prefix="C2F_18")
    conv("Conv_19", "conv9.0", "c2f18", "p4d", c4, c4, 3, 2, 1, True,
         "conv9", "cf2_conv_14")
    sf_sppf = "sppf" if quirk_6b else "p4d"
    nodes.append(ConcatNode(
        ("p4d", "sppf"), scale_from=sf_sppf, dst="cat_sppfx3",
        label="CONCAT_SPPFx3",
        declared_scale_from="p4d" if quirk_6b else None))
    c2f("C2F_21", b21, "cat_sppfx3", "c2f21", c4 + c5, c5, c5,
        dict(conv0_key_i=14, conv1_key_i=15, own="cf2_conv_14",
             b=_bottle_taps("C2F_21", nn), last="cf2_conv_15",
             next="x_down_0"),
        shortcut=False, label_prefix="C2F_21")

    # ---------------- detect heads ----------------
    def head(level_name, branch, key, src, cin, chid, cout, taps):
        conv(f"{level_name}_0", f"{key}.0", src, f"{key}.0o", cin, chid,
             3, 1, 1, True, taps[0], taps[1])
        conv(f"{level_name}_1", f"{key}.2", f"{key}.0o", f"{key}.1o", chid,
             chid, 3, 1, 1, True, taps[1], taps[2])
        conv(f"{level_name}_2", f"{key}.4", f"{key}.1o", f"{key}.out", chid,
             cout, 1, 1, 0, False, taps[2], None)
        return f"{key}.out"

    out_p3_box = head("x_result_5_up", "up", "detect_5_up", "c2f15", c3,
                      ch_box, 64, ["x_result_5_up_0", "x_result_5_up_1",
                           "x_result_5_up_2"])
    out_p3_cls = head("x_result_5_down", "down", "detect_5_down", "c2f15",
                      c3, ch_cls, 80, ["x_result_5_down_0",
                                       "x_result_5_down_1",
                                       "x_result_5_down_2"])
    out_p4_box = head("x_result_6_up", "up", "detect_6_up", "c2f18", c4,
                      ch_box, 64, ["x_result_6_up_0", "x_result_6_up_1",
                           "x_result_6_up_2"])
    out_p4_cls = head("x_result_6_down", "down", "detect_6_down", "c2f18",
                      c4, ch_cls, 80, ["x_result_6_down_0",
                                       "x_result_6_down_1",
                                       "x_result_6_down_2"])
    out_p5_box = head("x_up", "up", "detect_x_up", "c2f21", c5, ch_box, 64,
                      ["x_up_0", "x_up_1", "x_up_2"])
    out_p5_cls = head("x_down", "down", "detect_x_down", "c2f21", c5,
                      ch_cls, 80, ["x_down_0", "x_down_1", "x_down_2"])

    outputs = {
        "p3_box": out_p3_box, "p3_cls": out_p3_cls,
        "p4_box": out_p4_box, "p4_cls": out_p4_cls,
        "p5_box": out_p5_box, "p5_cls": out_p5_cls,
    }
    return Graph(cfg=cfg, nodes=tuple(nodes), input_edge="image",
                 outputs=outputs)


def _shape_walk(graph: Graph, image_size: int):
    """(edge -> (C, H, W) of one image, conv MACs per node) from a walk of
    the IR."""
    shapes = {graph.input_edge: (3, image_size, image_size)}
    costs = []
    for node in graph.nodes:
        if isinstance(node, ConvNode):
            _, h, w = shapes[node.src]
            ho = (h + 2 * node.padding - node.kernel) // node.stride + 1
            wo = (w + 2 * node.padding - node.kernel) // node.stride + 1
            shapes[node.dst] = (node.cout, ho, wo)
            costs.append(node.cin * node.cout * node.kernel ** 2 * ho * wo)
            continue
        costs.append(0)
        if isinstance(node, SplitNode):
            c, h, w = shapes[node.src]
            shapes[node.dst1] = shapes[node.dst2] = (c // 2, h, w)
        elif isinstance(node, ResidualAddNode):
            shapes[node.dst] = shapes[node.base]
        elif isinstance(node, ConcatNode):
            cs = [shapes[e] for e in node.srcs]
            shapes[node.dst] = (sum(c for c, _, _ in cs),) + cs[0][1:]
        elif isinstance(node, MaxPoolNode):
            c, h, w = shapes[node.src]
            ho = (h + 2 * node.padding - node.kernel) // node.stride + 1
            wo = (w + 2 * node.padding - node.kernel) // node.stride + 1
            shapes[node.dst] = (c, ho, wo)
        elif isinstance(node, UpsampleNode):
            c, h, w = shapes[node.src]
            shapes[node.dst] = (c, h * node.factor, w * node.factor)
    return shapes, costs


def node_costs(graph: Graph, image_size: int) -> List[int]:
    """Conv MACs of one image per node, 0 for the other nodes, from a shape
    walk of the IR (the JAX package's parallel/pipeline._node_costs, node
    for node): the numerator of the bench's mfu and the weight a pipeline
    stage balancer splits."""
    return _shape_walk(graph, image_size)[1]


def edge_shapes(graph: Graph, image_size: int) -> Dict[str, Tuple[int, int,
                                                                    int]]:
    """(C, H, W) of every edge for one image, from the same walk."""
    return _shape_walk(graph, image_size)[0]
