"""The YOLO11 graph, transcribed from ultralytics/cfg/models/11/yolo11.yaml
(the table ``YAML`` below, one entry a layer) into the node classes of
benchmark/reference/graph.py, with a ConvNode that carries ``groups`` and
an AttentionNode beside them.

Modules, as ultralytics nn/modules/{conv,block,head}.py define them (c2 a
block's width):
- Conv(c2, k, s): a k x k conv, stride s, padding k // 2, then SiLU; with
  act=False no SiLU; DWConv(c, c, 3) is a Conv whose groups are c;
- Bottleneck(c, c, k=(3, 3), e): cv1 (3x3 to c * e), cv2 (3x3 to c), plus
  the input;
- C3k(c, c, 2): cv1 and cv2 (1x1 to c / 2), two Bottlenecks at e = 1.0 on
  cv1's output, cv3 (1x1 to c) over cat(their output, cv2's);
- C3k2(c2, c3k, e), n repeats: cv1 (1x1 to 2c, c = c2 * e) split into
  halves; n inner blocks in sequence on the second half, each a C3k(c, c,
  2) where c3k holds or the scale is m, l or x (parse_model sets it
  there), else a Bottleneck(c, c, e=0.5); cv2 (1x1) over cat(both halves,
  each inner block's output);
- SPPF(c2, 5): cv1 (1x1 to c1 / 2), three 5x5 max-pools in sequence, cv2
  (1x1) over cat(cv1, the three pools);
- C2PSA(c2), n repeats: cv1 (1x1 to c2) split into a and b (c = c2 / 2
  each); n PSABlocks in sequence on b; cv2 (1x1) over cat(a, b). A
  PSABlock adds Attention(x) to x, then ffn(x) to x, ffn a Conv(c, 2c, 1)
  and a Conv(2c, c, 1, act=False). Attention over c // 64 heads, head_dim
  64, key_dim 32: qkv a Conv(c, c + 2 * 32 * heads, 1, act=False), then
  v . softmax(q^T k / sqrt(32))^T plus pe(v), pe a depthwise 3x3
  Conv(act=False) of v, then proj a Conv(c, c, 1, act=False);
- Detect over P3-P5, not legacy: a box branch Conv(x, c_box, 3), Conv(
  c_box, c_box, 3), Conv2d(c_box, 64, 1), c_box = max(16, P3 / 4, 64), and
  a class branch DWConv(x, x, 3), Conv(x, c_cls, 1), DWConv(c_cls, c_cls,
  3), Conv(c_cls, c_cls, 1), Conv2d(c_cls, 80, 1), c_cls = max(P3, 80).

A stage of c channels is make_divisible(min(c, max_channels) * width, 8)
wide; a module of n repeats has max(round(n * depth), 1).

The scale rules of the integer contract: a C3k2's, C2PSA's and the
SPPF's concat take cv1's scale, a C3k's its bottleneck chain's (cv1's); a
residual sum takes its input's (the attention's sum: the attention
output's, pe requantized into it); a neck concat after an upsample (FPN
up) takes the skip's scale; one after a stride-2 conv (PAN down)
requantizes the fresh conv into the skip's scale and hands on the fresh
conv's scale (the full-quant 6b seam); the plain convs inside the network
(qkv, pe, proj, the FFN's second) requantize their accumulator to int8 at
their own tap.

What the program's graph of the same model shares, conv by conv:
- ``name``: Conv_<i>, C3k2_<i>, SPPF_9, C2PSA_10 (i the yaml layer), then
  the path to the conv: _m<j> for inner block j, _cv1/_cv2/_cv3 for a
  block's own convs, _qkv/_pe/_proj/_ffn0/_ffn1 in a PSABlock;
  Detect_<level>_box_<j> and Detect_<level>_cls_<j> in the head;
- ``key``: the ultralytics state-dict prefix (model.<i>.conv,
  model.<i>.m.<j>.m.<k>.cv1.conv, model.10.m.0.attn.qkv.conv,
  model.23.cv3.<l>.0.0.conv...);
- ``tap``: the name;
- ``out_tap``: for a SiLU conv the tap of the next conv of the graph, but
  the last neck block's cv2 (layer 22) -> the first conv of its level's
  class head, as the three-level graph's last block hands on to x_down_0;
  for a plain conv inside the network its own tap; none for the head's
  Conv2d.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

from benchmark.reference import graph as _v8
from benchmark.reference.graph import (
    ConcatNode, Graph, MaxPoolNode, ResidualAddNode, SplitNode, UpsampleNode,
)
from benchmark.reference_yolo11.config import QuantConfig

# yolo11.yaml, backbone then head: (from, repeats, module, args)
YAML = (
    (-1, 1, "Conv", (64, 3, 2)),          # 0-P1/2
    (-1, 1, "Conv", (128, 3, 2)),         # 1-P2/4
    (-1, 2, "C3k2", (256, False, 0.25)),
    (-1, 1, "Conv", (256, 3, 2)),         # 3-P3/8
    (-1, 2, "C3k2", (512, False, 0.25)),
    (-1, 1, "Conv", (512, 3, 2)),         # 5-P4/16
    (-1, 2, "C3k2", (512, True)),
    (-1, 1, "Conv", (1024, 3, 2)),        # 7-P5/32
    (-1, 2, "C3k2", (1024, True)),
    (-1, 1, "SPPF", (1024, 5)),           # 9
    (-1, 2, "C2PSA", (1024,)),            # 10
    (-1, 1, "Upsample", ()),
    ((-1, 6), 1, "Concat", ()),           # cat backbone P4
    (-1, 2, "C3k2", (512, False)),        # 13
    (-1, 1, "Upsample", ()),
    ((-1, 4), 1, "Concat", ()),           # cat backbone P3
    (-1, 2, "C3k2", (256, False)),        # 16 (P3/8-small)
    (-1, 1, "Conv", (256, 3, 2)),
    ((-1, 13), 1, "Concat", ()),          # cat head P4
    (-1, 2, "C3k2", (512, False)),        # 19 (P4/16-medium)
    (-1, 1, "Conv", (512, 3, 2)),
    ((-1, 10), 1, "Concat", ()),          # cat head P5
    (-1, 2, "C3k2", (1024, True)),        # 22 (P5/32-large)
    ((16, 19, 22), 1, "Detect", ()),      # Detect(P3, P4, P5)
)
NC, REG_MAX = 80, 16
KEY_DIM, HEAD_DIM = 32, 64


@dataclasses.dataclass(frozen=True)
class ConvNode(_v8.ConvNode):
    """benchmark/reference/graph.py's conv with ``groups``: 1, or the
    channels of a depthwise conv, whose ``cin`` is then 1 (the weight's
    per-group shape). A plain conv (silu False) with an ``out_tap`` is a
    conv inside the network: its output is requantized to int8."""

    groups: int = 1


@dataclasses.dataclass(frozen=True)
class AttentionNode:
    """src: the qkv edge, head h's channels h * 128 + [0, 32) q, [32, 64)
    k, [64, 128) v; dst: the attention's output and v_dst: v, both in
    channel h * 64 + d; tap: the logits' calibration, out_tap: dst's."""

    name: str
    src: str
    dst: str
    v_dst: str
    heads: int
    key_dim: int
    head_dim: int
    tap: str
    out_tap: str


@dataclasses.dataclass
class _Layer:
    edge: str
    channels: int
    stride: int


def build_yolov8_graph(cfg: QuantConfig) -> Graph:
    """The YOLO11 graph at the configured scale (module docstring); the
    name is the interface's (benchmark/spec.py)."""
    depth, width, cap = cfg.depth, cfg.width, cfg.max_channels
    nodes: List = []
    layers: List[_Layer] = []
    outputs: Dict[str, str] = {}

    def channels(c: int) -> int:
        return math.ceil(min(c, cap) * width / 8) * 8

    def add_conv(name, key, src, dst, cin, cout, k=1, s=1, silu=True,
                 groups=1):
        nodes.append(ConvNode(name=name, key=key, src=src, dst=dst,
                              cin=cin // groups, cout=cout, kernel=k,
                              stride=s, padding=k // 2, silu=silu, tap=name,
                              groups=groups))

    def bottleneck(name, key, x, c, e, dst):
        h = int(c * e)
        add_conv(f"{name}_cv1", f"{key}.cv1.conv", x, f"{dst}.cv1", c, h, 3)
        add_conv(f"{name}_cv2", f"{key}.cv2.conv", f"{dst}.cv1",
                 f"{dst}.cv2", h, c, 3)
        nodes.append(ResidualAddNode(src=f"{dst}.cv2", base=x, dst=dst,
                                     label=f"{name}_add"))

    def c3k(name, key, x, c, dst):
        h = c // 2
        add_conv(f"{name}_cv1", f"{key}.cv1.conv", x, f"{dst}.cv1", c, h)
        add_conv(f"{name}_cv2", f"{key}.cv2.conv", x, f"{dst}.cv2", c, h)
        y = f"{dst}.cv1"
        for j in range(2):
            bottleneck(f"{name}_m{j}", f"{key}.m.{j}", y, h, 1.0,
                       f"{dst}.m{j}")
            y = f"{dst}.m{j}"
        nodes.append(ConcatNode((y, f"{dst}.cv2"), scale_from=f"{dst}.cv1",
                                dst=f"{dst}.cat", label=f"{name}_cat"))
        add_conv(f"{name}_cv3", f"{key}.cv3.conv", f"{dst}.cat", dst, 2 * h,
                 c)

    def psa_block(name, key, x, c, dst):
        heads = c // HEAD_DIM
        add_conv(f"{name}_qkv", f"{key}.attn.qkv.conv", x, f"{dst}.qkv", c,
                 heads * (2 * KEY_DIM + HEAD_DIM), silu=False)
        nodes.append(AttentionNode(f"{name}_attn", f"{dst}.qkv",
                                   f"{dst}.att", f"{dst}.v", heads, KEY_DIM,
                                   HEAD_DIM, f"{name}_attn_logits",
                                   f"{name}_attn"))
        add_conv(f"{name}_pe", f"{key}.attn.pe.conv", f"{dst}.v",
                 f"{dst}.pe", c, c, 3, silu=False, groups=c)
        nodes.append(ResidualAddNode(src=f"{dst}.pe", base=f"{dst}.att",
                                     dst=f"{dst}.x", label=f"{name}_pe"))
        add_conv(f"{name}_proj", f"{key}.attn.proj.conv", f"{dst}.x",
                 f"{dst}.proj", c, c, silu=False)
        nodes.append(ResidualAddNode(src=f"{dst}.proj", base=x,
                                     dst=f"{dst}.r1",
                                     label=f"{name}_attn_add"))
        add_conv(f"{name}_ffn0", f"{key}.ffn.0.conv", f"{dst}.r1",
                 f"{dst}.ffn0", c, 2 * c)
        add_conv(f"{name}_ffn1", f"{key}.ffn.1.conv", f"{dst}.ffn0",
                 f"{dst}.ffn1", 2 * c, c, silu=False)
        nodes.append(ResidualAddNode(src=f"{dst}.ffn1", base=f"{dst}.r1",
                                     dst=dst, label=f"{name}_ffn_add"))

    for i, (frm, n, module, args) in enumerate(YAML):
        srcs = [frm] if isinstance(frm, int) else list(frm)
        ins = [layers[i + f] if f < 0 else layers[f] for f in srcs] \
            if i else [_Layer("image", 3, 1)]
        x, key, dst = ins[0], f"model.{i}", f"L{i}"
        n = max(round(n * depth), 1)
        stride = x.stride
        if module in ("Conv", "C3k2", "SPPF", "C2PSA"):
            cout = channels(args[0])
        if module == "Conv":
            stride *= args[2]
            add_conv(f"Conv_{i}", f"{key}.conv", x.edge, dst, x.channels,
                     cout, args[1], args[2])
        elif module == "C3k2":
            name = f"C3k2_{i}"
            c = int(cout * (args[2] if len(args) > 2 else 0.5))
            add_conv(f"{name}_cv1", f"{key}.cv1.conv", x.edge, f"{dst}.cv1",
                     x.channels, 2 * c)
            nodes.append(SplitNode(f"{dst}.cv1", f"{dst}.a", f"{dst}.b"))
            parts = [f"{dst}.a", f"{dst}.b"]
            for j in range(n):
                if args[1] or cfg.scale in "mlx":
                    c3k(f"{name}_m{j}", f"{key}.m.{j}", parts[-1], c,
                        f"{dst}.m{j}")
                else:
                    bottleneck(f"{name}_m{j}", f"{key}.m.{j}", parts[-1], c,
                               0.5, f"{dst}.m{j}")
                parts.append(f"{dst}.m{j}")
            nodes.append(ConcatNode(tuple(parts), scale_from=f"{dst}.cv1",
                                    dst=f"{dst}.cat", label=f"{name}_cat"))
            add_conv(f"{name}_cv2", f"{key}.cv2.conv", f"{dst}.cat", dst,
                     c * len(parts), cout)
        elif module == "SPPF":
            c = x.channels // 2
            add_conv("SPPF_9_cv1", f"{key}.cv1.conv", x.edge, f"{dst}.cv1",
                     x.channels, c)
            pools = [f"{dst}.cv1"]
            for j in range(3):
                nodes.append(MaxPoolNode(pools[-1], f"{dst}.m{j}",
                                         f"SPPF_9_MAXPOOL_{j + 1}",
                                         kernel=args[1], stride=1,
                                         padding=args[1] // 2))
                pools.append(f"{dst}.m{j}")
            nodes.append(ConcatNode(tuple(pools), scale_from=f"{dst}.cv1",
                                    dst=f"{dst}.cat", label="SPPF_9_cat"))
            add_conv("SPPF_9_cv2", f"{key}.cv2.conv", f"{dst}.cat", dst,
                     4 * c, cout)
        elif module == "C2PSA":
            c = cout // 2
            add_conv("C2PSA_10_cv1", f"{key}.cv1.conv", x.edge, f"{dst}.cv1",
                     x.channels, 2 * c)
            nodes.append(SplitNode(f"{dst}.cv1", f"{dst}.a", f"{dst}.b"))
            y = f"{dst}.b"
            for j in range(n):
                psa_block(f"C2PSA_10_m{j}", f"{key}.m.{j}", y, c,
                          f"{dst}.m{j}")
                y = f"{dst}.m{j}"
            nodes.append(ConcatNode((f"{dst}.a", y), scale_from=f"{dst}.cv1",
                                    dst=f"{dst}.cat", label="C2PSA_10_cat"))
            add_conv("C2PSA_10_cv2", f"{key}.cv2.conv", f"{dst}.cat", dst,
                     2 * c, cout)
        elif module == "Upsample":
            nodes.append(UpsampleNode(x.edge, dst))
            cout, stride = x.channels, x.stride // 2
        elif module == "Concat":
            fresh, skip = ins
            pan_down = YAML[i - 1][2] == "Conv"
            nodes.append(ConcatNode(
                (fresh.edge, skip.edge), scale_from=skip.edge, dst=dst,
                label=f"CONCAT_{i}",
                declared_scale_from=fresh.edge if pan_down else None))
            cout = fresh.channels + skip.channels
        elif module == "Detect":
            box = max(16, ins[0].channels // 4, 4 * REG_MAX)
            cls = max(ins[0].channels, min(NC, 100))
            for li, lx in enumerate(ins):
                level = f"p{int(math.log2(lx.stride))}"
                name, k = f"Detect_{level}_box", f"{key}.cv2.{li}"
                add_conv(f"{name}_0", f"{k}.0.conv", lx.edge, f"{k}.0",
                         lx.channels, box, 3)
                add_conv(f"{name}_1", f"{k}.1.conv", f"{k}.0", f"{k}.1", box,
                         box, 3)
                add_conv(f"{name}_2", f"{k}.2", f"{k}.1", f"{k}.2", box,
                         4 * REG_MAX, silu=False)
                outputs[f"{level}_box"] = f"{k}.2"
                name, k = f"Detect_{level}_cls", f"{key}.cv3.{li}"
                add_conv(f"{name}_0", f"{k}.0.0.conv", lx.edge, f"{k}.0.0",
                         lx.channels, lx.channels, 3, groups=lx.channels)
                add_conv(f"{name}_1", f"{k}.0.1.conv", f"{k}.0.0",
                         f"{k}.0.1", lx.channels, cls)
                add_conv(f"{name}_2", f"{k}.1.0.conv", f"{k}.0.1",
                         f"{k}.1.0", cls, cls, 3, groups=cls)
                add_conv(f"{name}_3", f"{k}.1.1.conv", f"{k}.1.0",
                         f"{k}.1.1", cls, cls)
                add_conv(f"{name}_4", f"{k}.2", f"{k}.1.1", f"{k}.2", cls,
                         NC, silu=False)
                outputs[f"{level}_cls"] = f"{k}.2"
            break
        layers.append(_Layer(dst, cout, stride))

    convs = [j for j, node in enumerate(nodes) if isinstance(node, ConvNode)]
    last_block = f"C3k2_{len(YAML) - 2}_cv2"
    for j, nxt in zip(convs, convs[1:] + [None]):
        node = nodes[j]
        if node.silu:
            out_tap = ("Detect_p5_cls_0" if node.name == last_block
                       else nodes[nxt].tap)
        elif node.dst in outputs.values():
            continue
        else:
            out_tap = node.tap
        nodes[j] = dataclasses.replace(node, out_tap=out_tap)
    return Graph(cfg=cfg, nodes=tuple(nodes), input_edge="image",
                 outputs=outputs)


def edge_shapes(graph: Graph, image_size: int) -> Dict[str, Tuple[int, int,
                                                                    int]]:
    """(C, H, W) of every edge for one image, from a walk of the graph."""
    shapes = {graph.input_edge: (3, image_size, image_size)}
    for node in graph.nodes:
        if isinstance(node, ConvNode):
            _, h, w = shapes[node.src]
            ho = (h + 2 * node.padding - node.kernel) // node.stride + 1
            wo = (w + 2 * node.padding - node.kernel) // node.stride + 1
            shapes[node.dst] = (node.cout, ho, wo)
        elif isinstance(node, SplitNode):
            c, h, w = shapes[node.src]
            shapes[node.dst1] = shapes[node.dst2] = (c // 2, h, w)
        elif isinstance(node, ResidualAddNode):
            shapes[node.dst] = shapes[node.base]
        elif isinstance(node, ConcatNode):
            cs = [shapes[e] for e in node.srcs]
            shapes[node.dst] = (sum(c for c, _, _ in cs),) + cs[0][1:]
        elif isinstance(node, MaxPoolNode):
            shapes[node.dst] = shapes[node.src]     # 5x5, stride 1, pad 2
        elif isinstance(node, UpsampleNode):
            c, h, w = shapes[node.src]
            shapes[node.dst] = (c, h * node.factor, w * node.factor)
        elif isinstance(node, AttentionNode):
            _, h, w = shapes[node.src]
            shapes[node.dst] = shapes[node.v_dst] = (
                node.heads * node.head_dim, h, w)
    return shapes
