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

The port's own copy of alpha_yolo_quant_tpu/models/graph.py,
numpy logic unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

from alpha_yolo_quant_torch.config import QuantConfig


@dataclasses.dataclass(frozen=True)
class ConvNode:
    """Conv (+ optional fused-SiLU) node.

    tap: this conv's own calibration tap — the max-abs of its PRE-activation
      output is recorded under this name (reference stage_4.py:481-910).
    out_tap: the tap whose calibrated value the quantized pipeline uses to
      requantize this node's SiLU output (the `a_silu` argument threaded
      through reference stage_6.py; by the reference's convention it is the
      *next* conv's own tap). A plain conv (silu False) with an out_tap is
      a conv inside the network (YOLO11's attention and FFN convs): its
      accumulator is requantized to int8 at out_tap, its own tap. A plain
      conv without one is a head conv: its raw int32 accumulator is the
      output.
    cin: input channels of one group, the weight's second dimension
      (PyTorch's per-group shape): the edge's channels for a dense conv,
      1 for a depthwise one (DepthwiseConvNode).
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

    @property
    def requant_out(self) -> bool:
        """A plain conv inside the network: int8 output at out_tap."""
        return not self.silu and self.out_tap is not None

    @property
    def groups(self) -> int:
        """1; cout for a depthwise conv, the only grouped one."""
        return 1


@dataclasses.dataclass(frozen=True)
class DepthwiseConvNode(ConvNode):
    """A depthwise conv (YOLO11's DWConv and the attention's pe): groups =
    cout channels, each conv'd with its own (1, k, k) weights, so cin is
    1. The only grouped conv the graphs hold."""

    @property
    def groups(self) -> int:
        return self.cout


@dataclasses.dataclass(frozen=True)
class AttentionNode:
    """Multi-head self-attention over the pixels of one map (ultralytics
    Attention, the PSABlock of YOLO11's C2PSA).

    src is the qkv conv's output: head h owns channels h * (2 * key_dim +
    head_dim) + [0, key_dim) as q, the next key_dim as k and the last
    head_dim as v (ultralytics' view(B, heads, 2 * key_dim + head_dim,
    N)). dst is v . softmax(q^T k * key_dim^-0.5)^T, and v_dst the v
    channels alone (the pe conv's input), both in channel h * head_dim +
    d. tap: the calibration of the logits q^T k * key_dim^-0.5; out_tap:
    the calibration of dst."""

    name: str
    src: str
    dst: str
    v_dst: str
    heads: int
    key_dim: int
    head_dim: int
    tap: str
    out_tap: str


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
             MaxPoolNode, UpsampleNode, AttentionNode]


@dataclasses.dataclass(frozen=True)
class Graph:
    """The full network: ordered nodes + named head output edges.

    outputs maps role -> edge for the detect-head outputs, one
    '<level>_box' and one '<level>_cls' a level, levels in order:
    p3, p4, p5 (strides 8/16/32), and p6 (stride 64) in the P6 graph.
    """

    cfg: QuantConfig
    nodes: Tuple[Node, ...]
    input_edge: str
    outputs: Dict[str, str]

    def convs(self) -> List[ConvNode]:
        return [n for n in self.nodes if isinstance(n, ConvNode)]

    def attentions(self) -> List[AttentionNode]:
        return [n for n in self.nodes if isinstance(n, AttentionNode)]

    def conv_by_name(self, name: str) -> ConvNode:
        for n in self.convs():
            if n.name == name:
                return n
        raise KeyError(name)

    def head_conv(self, role: str) -> str:
        """The name of the plain head conv whose raw accumulator is the
        output ``role``."""
        return next(n.name for n in self.convs()
                    if n.dst == self.outputs[role])

    @property
    def levels(self) -> List[str]:
        """The detect levels ('p3', 'p4', ...) in the order of outputs."""
        return [r[:-len("_box")] for r in self.outputs if r.endswith("_box")]

    @property
    def param_keys(self) -> List[str]:
        """All conv param keys in graph order, plus 'dfl'."""
        return [c.key for c in self.convs()] + ["dfl"]


# the detect levels of the hardware contract: the Verilog tree and the
# reference's SRAM schedule have these three
CONTRACT_LEVELS = ("p3", "p4", "p5")


def require_contract_levels(graph: Graph, what: str) -> None:
    """Refuse, naming ``what``, a graph whose detect levels are not the
    hardware contract's (a P6 graph has a fourth)."""
    if tuple(graph.levels) != CONTRACT_LEVELS:
        raise ValueError(
            f"{what}: the hardware contract has the detect levels "
            f"{', '.join(CONTRACT_LEVELS)}; {graph.cfg.model} has "
            f"{', '.join(graph.levels)}")


def dense_graph(graph: Graph) -> bool:
    """No depthwise conv and no attention: the YOLOv8 graphs."""
    return not (graph.attentions() or any(n.groups > 1
                                          for n in graph.convs()))


def require_dense_graph(graph: Graph, what: str) -> None:
    """Refuse, naming ``what``, a graph with depthwise convs or attention
    (YOLO11): the hardware contract (the Verilog tree, the SRAM schedule,
    the checkpoint remap) and the slab and nibble-split engines have
    neither."""
    if not dense_graph(graph):
        dw = sum(n.groups > 1 for n in graph.convs())
        att = len(graph.attentions())
        raise ValueError(
            f"{what}: the hardware contract has dense convs and no "
            f"attention; {graph.cfg.model} has {dw} depthwise convs and "
            f"{att} attention nodes")


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

    A P6 model name (``cfg.p6``) builds the four-level graph instead
    (build_yolov8_p6_graph), a YOLO11 name (``cfg.yolo11``) the YOLO11
    graph (build_yolo11_graph).
    """
    if cfg.p6:
        return build_yolov8_p6_graph(cfg)
    if cfg.yolo11:
        return build_yolo11_graph(cfg)
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


def build_yolov8_p6_graph(cfg: QuantConfig) -> Graph:
    """YOLOv8-P6 as ultralytics/cfg/models/v8/yolov8-p6.yaml declares it
    (yaml layer i below), at the configured scale.

    Backbone: as YOLOv8 up to P5 (layers 0-8), the P5 stage
    Conv(768, 3, 2) + C2f(768, n=3, shortcut); a sixth stage at stride 64,
    Conv(1024, 3, 2) + C2f(1024, n=3, shortcut) + SPPF(1024, 5) (9-11).
    Neck up (12-20): upsample, concat with the backbone's P5, P4, then P3
    C2f output, each followed by C2(768 | 512 | 256, n=3, no shortcut).
    Neck down (21-29): Conv(c, 3, 2), concat with the neck block of the
    level above (the last one with the SPPF), C2(512 | 768 | 1024).
    Detect over P3-P6 (30): box width max(16, P3 // 4, 64), cls width
    max(P3, 80). A stage of c channels is min(c, max_channels) * width
    wide, rounded up to 8; a block of n repeats has max(round(n * depth),
    1).

    C2 (ultralytics nn/modules/block.py): cv1 is a 1x1 conv to 2c (c half
    the block's width), split into halves a and b; n bottlenecks (3x3 then
    3x3, c to c, no residual) run in sequence on a; cv2 is a 1x1 conv over
    cat(m(a), b). Its concat takes cv1's scale, as a neck C2f's does.

    Scale rules are the three-level graph's: an FPN-up concat takes the
    skip's scale; the three PAN-down seams take the full-quant 6b
    direction (the fresh conv requantized to the skip's scale, the fresh
    scale declared; stage8_concat_flow the other); the third residual sum
    is clipped (the backbone's residuals are the three-level graph's).

    Naming: the backbone up to P5 keeps the three-level conv names
    (Conv_P1 ... C2F_8_conv_1), the neck's blocks are C2_<i> and
    Conv_<i>, the heads of p3/p4/p5 keep theirs (x_result_5_*,
    x_result_6_*, x_*) and every conv whose output is at stride 64 starts
    with ``P6_``. Keys are the ultralytics state-dict prefixes
    (``model.<i>.cv1.conv``, ``model.30.cv2.<level>.<j>``...). Each
    conv's tap is its name; its out_tap is the tap of the next conv in
    graph order, except the last neck block's cv2, whose out_tap is the
    first conv of its level's cls head (as C2F_21 -> x_down_0 in the
    three-level graph). In a C2 that gives: cv1 -> the first bottleneck
    conv, each bottleneck conv -> the next, the last one -> cv2, cv2 ->
    the next block's first conv.
    """
    w, d, mc = cfg.width, cfg.depth, cfg.max_channels

    def ch(c: int) -> int:
        return -(-int(min(c, mc) * w) // 8) * 8

    def reps(n: int) -> int:
        return max(int(round(n * d)), 1)

    nodes: List[Node] = []

    def conv(name, key, src, dst, cin, cout, k=3, s=1, silu=True):
        nodes.append(ConvNode(name=name, key=key, src=src, dst=dst, cin=cin,
                              cout=cout, kernel=k, stride=s, padding=k // 2,
                              silu=silu, tap=name))

    def csp(kind, prefix, i, src, dst, cin, cout, n):
        """C2f (shortcut, the backbone) or C2 (no shortcut, the neck) at
        yaml layer i."""
        c = cout // 2
        m = f"model.{i}"
        conv(f"{prefix}_conv_0", f"{m}.cv1.conv", src, f"{dst}.c0", cin,
             2 * c, 1)
        nodes.append(SplitNode(f"{dst}.c0", f"{dst}.x1", f"{dst}.x2"))
        prev = f"{dst}.x1" if kind == "C2" else f"{dst}.x2"
        parts = [] if kind == "C2" else [f"{dst}.x1", f"{dst}.x2"]
        for j in range(n):
            conv(f"{prefix}_bottle_{2 * j}", f"{m}.m.{j}.cv1.conv", prev,
                 f"{dst}.b{j}.0", c, c)
            conv(f"{prefix}_bottle_{2 * j + 1}", f"{m}.m.{j}.cv2.conv",
                 f"{dst}.b{j}.0", f"{dst}.b{j}.1", c, c)
            if kind == "C2f":
                nodes.append(ResidualAddNode(
                    src=f"{dst}.b{j}.1", base=prev, dst=f"{dst}.s{j}",
                    label=f"{prefix}_bottle_{2 * j + 1}"))
                prev = f"{dst}.s{j}"
                parts.append(prev)
            else:
                prev = f"{dst}.b{j}.1"
        if kind == "C2":
            parts = [prev, f"{dst}.x2"]
        nodes.append(ConcatNode(srcs=tuple(parts), scale_from=f"{dst}.c0",
                                dst=f"{dst}.cat",
                                label=f"{prefix}_bottle_{2 * n - 1}"))
        conv(f"{prefix}_conv_1", f"{m}.cv2.conv", f"{dst}.cat", dst,
             c * len(parts), cout, 1)

    c1, c2, c3, c4 = ch(64), ch(128), ch(256), ch(512)
    c5, c6 = ch(768), ch(1024)
    n3, n6 = reps(3), reps(6)

    # ---------------- backbone (0-11) ----------------
    conv("Conv_P1", "model.0.conv", "image", "p1", 3, c1, s=2)
    conv("Conv_P2", "model.1.conv", "p1", "p2", c1, c2, s=2)
    csp("C2f", "C2F_2", 2, "p2", "c2f2", c2, c2, n3)
    conv("Conv_P3", "model.3.conv", "c2f2", "p3", c2, c3, s=2)
    csp("C2f", "C2F_4", 4, "p3", "c2f4", c3, c3, n6)
    conv("Conv_P4", "model.5.conv", "c2f4", "p4", c3, c4, s=2)
    csp("C2f", "C2F_6", 6, "p4", "c2f6", c4, c4, n6)
    conv("Conv_P5", "model.7.conv", "c2f6", "p5", c4, c5, s=2)
    csp("C2f", "C2F_8", 8, "p5", "c2f8", c5, c5, n3)
    conv("P6_Conv_P6", "model.9.conv", "c2f8", "p6", c5, c6, s=2)
    csp("C2f", "P6_C2F_10", 10, "p6", "c2f10", c6, c6, n3)
    conv("P6_SPPF_conv_0", "model.11.cv1.conv", "c2f10", "sppf.c0", c6,
         c6 // 2, 1)
    nodes.append(MaxPoolNode("sppf.c0", "sppf.m1", "P6_MAXPOOLING_X1"))
    nodes.append(MaxPoolNode("sppf.m1", "sppf.m2", "P6_MAXPOOLING_X2"))
    nodes.append(MaxPoolNode("sppf.m2", "sppf.m3", "P6_MAXPOOLING_X3"))
    nodes.append(ConcatNode(("sppf.c0", "sppf.m1", "sppf.m2", "sppf.m3"),
                            scale_from="sppf.c0", dst="sppf.cat",
                            label="P6_SPPF_POOLCAT"))
    conv("P6_SPPF_conv_1", "model.11.cv2.conv", "sppf.cat", "sppf",
         c6 // 2 * 4, c6, 1)

    # ---------------- neck, FPN up (12-20) ----------------
    # (upsampled, skip), in the skip's scale
    top, top_c = "sppf", c6
    for i, skip, skip_c, cout in ((12, "c2f8", c5, c5), (15, "c2f6", c4, c4),
                                  (18, "c2f4", c3, c3)):
        nodes.append(UpsampleNode(top, f"up{i}"))
        nodes.append(ConcatNode((f"up{i}", skip), scale_from=skip,
                                dst=f"cat{i + 1}", label=f"CONCAT_{i + 1}"))
        csp("C2", f"C2_{i + 2}", i + 2, f"cat{i + 1}", f"c2_{i + 2}",
            top_c + skip_c, cout, n3)
        top, top_c = f"c2_{i + 2}", cout

    # ---------------- neck, PAN down (21-29) ----------------
    # (fresh conv, skip); the full-quant 6b seam requantizes the fresh side
    # into the skip's scale and declares the fresh one (ConcatNode docs)
    quirk_6b = cfg.full_quant and not cfg.stage8_concat_flow
    for i, skip, skip_c, cout, p6 in ((21, "c2_17", c4, c4, ""),
                                      (24, "c2_14", c5, c5, ""),
                                      (27, "sppf", c6, c6, "P6_")):
        conv(f"{p6}Conv_{i}", f"model.{i}.conv", top, f"down{i}", top_c,
             top_c, s=2)
        nodes.append(ConcatNode(
            (f"down{i}", skip), scale_from=skip if quirk_6b else f"down{i}",
            dst=f"cat{i + 1}", label=f"{p6}CONCAT_{i + 1}",
            declared_scale_from=f"down{i}" if quirk_6b else None))
        csp("C2", f"{p6}C2_{i + 2}", i + 2, f"cat{i + 1}", f"c2_{i + 2}",
            top_c + skip_c, cout, n3)
        top, top_c = f"c2_{i + 2}", cout

    # ---------------- Detect over P3-P6 (30) ----------------
    ch_box = max(16, c3 // 4, 64)
    ch_cls = max(c3, 80)
    outputs: Dict[str, str] = {}
    for li, (level, src, cin, name) in enumerate((
            ("p3", "c2_20", c3, "x_result_5"), ("p4", "c2_23", c4,
                                                "x_result_6"),
            ("p5", "c2_26", c5, "x"), ("p6", "c2_29", c6, "P6_x"))):
        for kind, branch, cv, hid, cout in (("box", "up", "cv2", ch_box, 64),
                                            ("cls", "down", "cv3", ch_cls,
                                             80)):
            key, nm = f"model.30.{cv}.{li}", f"{name}_{branch}"
            conv(f"{nm}_0", f"{key}.0.conv", src, f"{key}.0o", cin, hid)
            conv(f"{nm}_1", f"{key}.1.conv", f"{key}.0o", f"{key}.1o", hid,
                 hid)
            conv(f"{nm}_2", f"{key}.2", f"{key}.1o", f"{key}.out", hid,
                 cout, 1, silu=False)
            outputs[f"{level}_{kind}"] = f"{key}.out"

    # out_tap: the next conv's tap in graph order; the last neck block's
    # cv2 hands on to the first conv of the P6 cls head
    order = [i for i, n in enumerate(nodes) if isinstance(n, ConvNode)]
    for i, j in zip(order, order[1:] + [None]):
        n = nodes[i]
        nxt = ("P6_x_down_0" if n.name == "P6_C2_29_conv_1"
               else nodes[j].tap if j is not None else None)
        nodes[i] = dataclasses.replace(n, out_tap=nxt if n.silu else None)
    return Graph(cfg=cfg, nodes=tuple(nodes), input_edge="image",
                 outputs=outputs)


def build_yolo11_graph(cfg: QuantConfig) -> Graph:
    """YOLO11 as ultralytics/cfg/models/11/yolo11.yaml declares it (yaml
    layer i below), at the configured scale; the modules are those of
    ultralytics/nn/modules/{block,conv,head}.py.

    Backbone (0-10): Conv(64, 3, 2), Conv(128, 3, 2), C3k2(256, e=0.25),
    Conv(256, 3, 2), C3k2(512, e=0.25), Conv(512, 3, 2), C3k2(512),
    Conv(1024, 3, 2), C3k2(1024), SPPF(1024, 5), C2PSA(1024). Neck
    (11-22): upsample, concat with layer 6, C3k2(512); upsample, concat
    with 4, C3k2(256) (P3); Conv(256, 3, 2), concat with 13, C3k2(512)
    (P4); Conv(512, 3, 2), concat with 10, C3k2(1024) (P5). Detect (23)
    over P3-P5 in its non-legacy form. A stage of c channels is
    min(c, max_channels) * width wide, rounded up to 8; a block of n
    repeats has max(round(n * depth), 1).

    C3k2(c2, c3k, e): a C2f whose cv1 (1x1 to 2c, c = c2 * e) is split in
    halves; n inner blocks run in sequence on the second half, each a
    C3k(c, c, 2) where c3k holds (every block at the m, l and x scales,
    layers 6, 8 and 22 at every scale), else a Bottleneck(c, c, k=3/3,
    e=0.5); cv2 is a 1x1 conv over cat(halves, every inner output). The
    shortcut is on in every block. C3k: cv3(cat(m(cv1 x), cv2 x)), cv1
    and cv2 1x1 to c/2, m two Bottlenecks 3x3/3x3 at e=1.0. A Bottleneck
    adds its input to cv2(cv1 x).

    C2PSA(c): cv1 (1x1 to c) split into a and b, n PSABlocks on b, cv2
    over cat(a, b). PSABlock: x = x + Attention(x), x = x + ffn(x), ffn a
    1x1 conv to 2c with SiLU and a plain 1x1 conv back. Attention over
    heads = c // 64, head_dim 64, key_dim 32: qkv a plain 1x1 conv to
    c + 2 * key_dim * heads, the AttentionNode, pe a plain depthwise 3x3
    conv of v, added to the attention's output, and proj a plain 1x1
    conv.

    Detect: per level a box branch Conv(x, c_box, 3), Conv(c_box, c_box,
    3), Conv2d(c_box, 64, 1), c_box = max(16, P3 // 4, 64), and a cls
    branch DWConv(x, x, 3), Conv(x, c_cls, 1), DWConv(c_cls, c_cls, 3),
    Conv(c_cls, c_cls, 1), Conv2d(c_cls, 80, 1), c_cls = max(P3, 80).
    DWConv is a depthwise 3x3 conv with SiLU.

    Scale rules are the three-level graph's: an inner block's output is
    requantized into cv1's scale at its C3k2's concat and cv2's output
    into the bottleneck chain's at a C3k's; a residual sum takes its
    input's scale; an FPN-up concat takes the skip's scale; the two
    PAN-down seams take the full-quant 6b direction (stage8_concat_flow
    the other); the third residual sum is clipped. The attention's pe is
    requantized into the attention output's scale at their sum.

    Naming: a conv's name starts with its yaml module and layer
    (``C3k2_6_m0_m1_cv2``, ``C2PSA_10_m0_qkv``, ``Detect_p3_cls_2``);
    keys are the ultralytics state-dict prefixes (``model.6.m.0.m.1.cv2.
    conv``, ``model.23.cv3.0.1.0.conv``...). Each conv's tap is its name.
    A SiLU conv's out_tap is the tap of the next conv in graph order,
    except the last neck block's cv2, whose out_tap is the first conv of
    its level's cls head (as P6); a plain conv inside the network has its
    own tap; the head's plain convs none.
    """
    w, d, mc = cfg.width, cfg.depth, cfg.max_channels

    def ch(c: int) -> int:
        return -(-int(min(c, mc) * w) // 8) * 8

    def reps(n: int) -> int:
        return max(int(round(n * d)), 1)

    # parse_model turns c3k on in every C3k2 at the m, l and x scales
    c3k_all = cfg.model[-1] in "mlx"
    nodes: List[Node] = []

    def conv(name, key, src, dst, cin, cout, k=1, s=1, silu=True,
             node=ConvNode):
        nodes.append(node(name=name, key=key, src=src, dst=dst, cin=cin,
                          cout=cout, kernel=k, stride=s, padding=k // 2,
                          silu=silu, tap=name))

    def dwconv(name, key, src, dst, c, silu=True):
        conv(name, key, src, dst, 1, c, 3, silu=silu, node=DepthwiseConvNode)

    def bottleneck(prefix, m, src, dst, c, e):
        c_ = int(c * e)
        conv(f"{prefix}_cv1", f"{m}.cv1.conv", src, f"{dst}.0", c, c_, 3)
        conv(f"{prefix}_cv2", f"{m}.cv2.conv", f"{dst}.0", f"{dst}.1", c_,
             c, 3)
        nodes.append(ResidualAddNode(src=f"{dst}.1", base=src, dst=dst,
                                     label=f"{prefix}_add"))

    def c3k(prefix, m, src, dst, c):
        c_ = c // 2
        conv(f"{prefix}_cv1", f"{m}.cv1.conv", src, f"{dst}.a", c, c_)
        conv(f"{prefix}_cv2", f"{m}.cv2.conv", src, f"{dst}.b", c, c_)
        prev = f"{dst}.a"
        for j in range(2):
            bottleneck(f"{prefix}_m{j}", f"{m}.m.{j}", prev, f"{dst}.m{j}",
                       c_, 1.0)
            prev = f"{dst}.m{j}"
        nodes.append(ConcatNode((prev, f"{dst}.b"), scale_from=prev,
                                dst=f"{dst}.cat", label=f"{prefix}_cat"))
        conv(f"{prefix}_cv3", f"{m}.cv3.conv", f"{dst}.cat", dst, 2 * c_, c)

    def c3k2(i, src, dst, c1, c2, inner_c3k, e=0.5):
        prefix, m = f"C3k2_{i}", f"model.{i}"
        c = int(c2 * e)
        conv(f"{prefix}_cv1", f"{m}.cv1.conv", src, f"{dst}.c0", c1, 2 * c)
        nodes.append(SplitNode(f"{dst}.c0", f"{dst}.x1", f"{dst}.x2"))
        parts = [f"{dst}.x1", f"{dst}.x2"]
        for j in range(reps(2)):
            if inner_c3k or c3k_all:
                c3k(f"{prefix}_m{j}", f"{m}.m.{j}", parts[-1],
                    f"{dst}.m{j}", c)
            else:
                bottleneck(f"{prefix}_m{j}", f"{m}.m.{j}", parts[-1],
                           f"{dst}.m{j}", c, 0.5)
            parts.append(f"{dst}.m{j}")
        nodes.append(ConcatNode(tuple(parts), scale_from=f"{dst}.c0",
                                dst=f"{dst}.cat", label=f"{prefix}_cat"))
        conv(f"{prefix}_cv2", f"{m}.cv2.conv", f"{dst}.cat", dst,
             c * len(parts), c2)

    def psa_block(prefix, m, src, dst, c):
        heads = c // 64
        hd = c // heads
        kd = hd // 2
        conv(f"{prefix}_qkv", f"{m}.attn.qkv.conv", src, f"{dst}.qkv", c,
             c + 2 * kd * heads, silu=False)
        nodes.append(AttentionNode(
            name=f"{prefix}_attn", src=f"{dst}.qkv", dst=f"{dst}.att",
            v_dst=f"{dst}.v", heads=heads, key_dim=kd, head_dim=hd,
            tap=f"{prefix}_attn_logits", out_tap=f"{prefix}_attn"))
        dwconv(f"{prefix}_pe", f"{m}.attn.pe.conv", f"{dst}.v", f"{dst}.pe",
               c, silu=False)
        nodes.append(ResidualAddNode(src=f"{dst}.pe", base=f"{dst}.att",
                                     dst=f"{dst}.ap", label=f"{prefix}_pe"))
        conv(f"{prefix}_proj", f"{m}.attn.proj.conv", f"{dst}.ap",
             f"{dst}.proj", c, c, silu=False)
        nodes.append(ResidualAddNode(src=f"{dst}.proj", base=src,
                                     dst=f"{dst}.s0",
                                     label=f"{prefix}_attn_add"))
        conv(f"{prefix}_ffn0", f"{m}.ffn.0.conv", f"{dst}.s0", f"{dst}.f0",
             c, 2 * c)
        conv(f"{prefix}_ffn1", f"{m}.ffn.1.conv", f"{dst}.f0", f"{dst}.f1",
             2 * c, c, silu=False)
        nodes.append(ResidualAddNode(src=f"{dst}.f1", base=f"{dst}.s0",
                                     dst=dst, label=f"{prefix}_ffn_add"))

    c1, c2, c3, c4, c5 = ch(64), ch(128), ch(256), ch(512), ch(1024)

    # ---------------- backbone (0-10) ----------------
    conv("Conv_0", "model.0.conv", "image", "p1", 3, c1, 3, 2)
    conv("Conv_1", "model.1.conv", "p1", "p2", c1, c2, 3, 2)
    c3k2(2, "p2", "c3k2_2", c2, c3, False, 0.25)
    conv("Conv_3", "model.3.conv", "c3k2_2", "p3", c3, c3, 3, 2)
    c3k2(4, "p3", "c3k2_4", c3, c4, False, 0.25)
    conv("Conv_5", "model.5.conv", "c3k2_4", "p4", c4, c4, 3, 2)
    c3k2(6, "p4", "c3k2_6", c4, c4, True)
    conv("Conv_7", "model.7.conv", "c3k2_6", "p5", c4, c5, 3, 2)
    c3k2(8, "p5", "c3k2_8", c5, c5, True)
    conv("SPPF_9_cv1", "model.9.cv1.conv", "c3k2_8", "sppf.c0", c5,
         c5 // 2)
    for j in (1, 2, 3):
        nodes.append(MaxPoolNode(f"sppf.m{j - 1}" if j > 1 else "sppf.c0",
                                 f"sppf.m{j}", f"SPPF_9_MAXPOOL_{j}"))
    nodes.append(ConcatNode(("sppf.c0", "sppf.m1", "sppf.m2", "sppf.m3"),
                            scale_from="sppf.c0", dst="sppf.cat",
                            label="SPPF_9_cat"))
    conv("SPPF_9_cv2", "model.9.cv2.conv", "sppf.cat", "sppf", c5 // 2 * 4,
         c5)
    c = c5 // 2
    conv("C2PSA_10_cv1", "model.10.cv1.conv", "sppf", "psa.c0", c5, 2 * c)
    nodes.append(SplitNode("psa.c0", "psa.a", "psa.b"))
    prev = "psa.b"
    for j in range(reps(2)):
        psa_block(f"C2PSA_10_m{j}", f"model.10.m.{j}", prev, f"psa.m{j}", c)
        prev = f"psa.m{j}"
    nodes.append(ConcatNode(("psa.a", prev), scale_from="psa.c0",
                            dst="psa.cat", label="C2PSA_10_cat"))
    conv("C2PSA_10_cv2", "model.10.cv2.conv", "psa.cat", "c2psa_10", 2 * c,
         c5)

    # ---------------- neck, FPN up (11-16) ----------------
    # (upsampled, skip), in the skip's scale
    nodes.append(UpsampleNode("c2psa_10", "up11"))
    nodes.append(ConcatNode(("up11", "c3k2_6"), scale_from="c3k2_6",
                            dst="cat12", label="CONCAT_12"))
    c3k2(13, "cat12", "c3k2_13", c5 + c4, c4, False)
    nodes.append(UpsampleNode("c3k2_13", "up14"))
    nodes.append(ConcatNode(("up14", "c3k2_4"), scale_from="c3k2_4",
                            dst="cat15", label="CONCAT_15"))
    c3k2(16, "cat15", "c3k2_16", c4 + c4, c3, False)

    # ---------------- neck, PAN down (17-22) ----------------
    # (fresh conv, skip); the full-quant 6b seam requantizes the fresh side
    # into the skip's scale and declares the fresh one (ConcatNode docs)
    quirk_6b = cfg.full_quant and not cfg.stage8_concat_flow
    top, top_c = "c3k2_16", c3
    for i, skip, skip_c, cout in ((17, "c3k2_13", c4, c4),
                                  (20, "c2psa_10", c5, c5)):
        conv(f"Conv_{i}", f"model.{i}.conv", top, f"down{i}", top_c, top_c,
             3, 2)
        nodes.append(ConcatNode(
            (f"down{i}", skip), scale_from=skip if quirk_6b else f"down{i}",
            dst=f"cat{i + 1}", label=f"CONCAT_{i + 1}",
            declared_scale_from=f"down{i}" if quirk_6b else None))
        c3k2(i + 2, f"cat{i + 1}", f"c3k2_{i + 2}", top_c + skip_c, cout,
             i == 20)
        top, top_c = f"c3k2_{i + 2}", cout

    # ---------------- Detect over P3-P5 (23) ----------------
    ch_box = max(16, c3 // 4, 64)
    ch_cls = cfg.detect_cls_channels
    outputs: Dict[str, str] = {}
    for li, (level, src, cin) in enumerate((
            ("p3", "c3k2_16", c3), ("p4", "c3k2_19", c4),
            ("p5", "c3k2_22", c5))):
        nm, key = f"Detect_{level}_box", f"model.23.cv2.{li}"
        conv(f"{nm}_0", f"{key}.0.conv", src, f"{key}.0o", cin, ch_box, 3)
        conv(f"{nm}_1", f"{key}.1.conv", f"{key}.0o", f"{key}.1o", ch_box,
             ch_box, 3)
        conv(f"{nm}_2", f"{key}.2", f"{key}.1o", f"{key}.out", ch_box, 64,
             silu=False)
        outputs[f"{level}_box"] = f"{key}.out"
        nm, key = f"Detect_{level}_cls", f"model.23.cv3.{li}"
        dwconv(f"{nm}_0", f"{key}.0.0.conv", src, f"{key}.0o", cin)
        conv(f"{nm}_1", f"{key}.0.1.conv", f"{key}.0o", f"{key}.1o", cin,
             ch_cls)
        dwconv(f"{nm}_2", f"{key}.1.0.conv", f"{key}.1o", f"{key}.2o",
               ch_cls)
        conv(f"{nm}_3", f"{key}.1.1.conv", f"{key}.2o", f"{key}.3o", ch_cls,
             ch_cls)
        conv(f"{nm}_4", f"{key}.2", f"{key}.3o", f"{key}.out", ch_cls, 80,
             silu=False)
        outputs[f"{level}_cls"] = f"{key}.out"

    # out_tap: the next conv's tap in graph order for a SiLU conv (the
    # last neck block's cv2 hands on to its level's first cls conv), its
    # own for a plain conv inside the network, none for a head conv
    order = [i for i, n in enumerate(nodes) if isinstance(n, ConvNode)]
    for i, j in zip(order, order[1:] + [None]):
        n = nodes[i]
        if n.silu:
            nxt = ("Detect_p5_cls_0" if n.name == "C3k2_22_cv2"
                   else nodes[j].tap if j is not None else None)
        else:
            nxt = None if n.dst in outputs.values() else n.tap
        nodes[i] = dataclasses.replace(n, out_tap=nxt)
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
        elif isinstance(node, AttentionNode):
            _, h, w = shapes[node.src]
            shapes[node.dst] = shapes[node.v_dst] = (
                node.heads * node.head_dim, h, w)
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
