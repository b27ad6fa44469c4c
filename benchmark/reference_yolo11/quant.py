"""The integer constants of the quantized YOLO11 network, worked out from
the fused float parameters and the calibration (``max_a``) with the
arithmetic of benchmark/reference/quant.py (scales, per-channel weights,
truncated biases, rescale/shift pairs, LUTs, the full-quant head), over a
graph that also holds depthwise convs, plain convs inside the network and
attention nodes:

- a depthwise conv quantizes its (C, 1, 3, 3) weights per output channel,
  as a dense conv does;
- a plain conv inside the network (silu False with an out_tap) requantizes
  its accumulator once to int8 at scale_for(max_a[out_tap], K), clamped to
  the largest scale its 8-bit rescale reaches, as a SiLU output is;
- an attention node takes q, k and v at its input's scale s; its logits
  q^T k carry s^2 * sqrt(key_dim) per unit of q^T k / sqrt(key_dim) and
  are requantized to 8 bits at scale_for(max_a[tap], 8), clamped the same
  way (the tap's max-abs then follows the clamp); the exponent table is
  exponent_lut(that max-abs, 8); its output, floored in s, is requantized
  to scale_for(max_a[out_tap], K), clamped likewise;
- the full-quant contract clips the third residual sum of the graph, as
  it does in YOLOv8.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from benchmark.reference.graph import (
    ConcatNode, Graph, MaxPoolNode, ResidualAddNode, SplitNode, UpsampleNode,
)
from benchmark.reference.quant import (
    ConvQ, HeadQ, Lut, QModel, derive_rescale_shift, exponent_lut, quant_bias,
    quant_matrix, scale_for, sigmoid_lut,
)
from benchmark.reference_yolo11.config import QuantConfig
from benchmark.reference_yolo11.graph import AttentionNode, ConvNode

HEAD_CONVS = {level: (f"Detect_{level}_box_2", f"Detect_{level}_cls_4")
              for level in ("p3", "p4", "p5")}


@dataclasses.dataclass
class AttnQ:
    node: AttentionNode
    in_scale: float
    logit_r: int
    logit_s: int
    exp_lut: Lut
    out_r: int
    out_s: int


@dataclasses.dataclass
class QModel11(QModel):
    attns: Dict[str, AttnQ] = dataclasses.field(default_factory=dict)


def _reachable(scale: float, old: float, kb: int) -> float:
    """The calibrated scale, or the largest the kb-bit rescale reaches from
    ``old`` where it is larger."""
    return min(scale, old * 2.0 ** (kb - 2))


def quantize_model(graph: Graph, params: Dict, max_a: Dict[str, float],
                   cfg: QuantConfig) -> QModel11:
    """Every integer constant of the full-quant YOLO11 network."""
    if not cfg.full_quant:
        raise ValueError("the reference serves the full-quant pipeline")
    k, qmax, kb = cfg.k, cfg.qmax, cfg.koeff_bits
    sig_scale = scale_for(cfg.sigmoid_lut_domain, k)
    scale = {graph.input_edge: scale_for(1.0, k)}
    amax = {graph.input_edge: qmax}
    convs: Dict[str, ConvQ] = {}
    attns: Dict[str, AttnQ] = {}
    requants: Dict[Tuple[int, str], Tuple[int, int]] = {}
    clip_after: Dict[int, int] = {}

    def requant(idx, src, old, new):
        r, s = derive_rescale_shift(np.float64(old), float(new), kb)
        requants[(idx, src)] = (int(r), int(s))

    n_res = 0
    for idx, node in enumerate(graph.nodes):
        if isinstance(node, ConvNode):
            p = params[node.key]
            w_q, w_scales = quant_matrix(np.asarray(p["w"]), k)
            acc_scale = scale[node.src] * w_scales[:, 0]
            b_q = quant_bias(np.asarray(p["b"], np.float64), acc_scale)
            c = ConvQ(node, w_q, b_q, acc_scale)
            if node.silu:
                old2 = scale_for(1.0, k) * acc_scale
                out_s = _reachable(scale_for(max_a[node.out_tap], k),
                                   float(np.min(old2)), kb)
                c.r1, c.s1 = derive_rescale_shift(acc_scale, sig_scale, kb)
                c.r2, c.s2 = derive_rescale_shift(old2, out_s, kb)
                scale[node.dst], amax[node.dst] = float(out_s), qmax
            elif node.out_tap is not None:
                out_s = _reachable(scale_for(max_a[node.out_tap], k),
                                   float(np.min(acc_scale)), kb)
                c.r2, c.s2 = derive_rescale_shift(acc_scale, out_s, kb)
                scale[node.dst], amax[node.dst] = float(out_s), qmax
            else:
                scale[node.dst], amax[node.dst] = float("nan"), 0
            convs[node.name] = c
        elif isinstance(node, AttentionNode):
            s = scale[node.src]
            logit_old = s ** 2 * node.key_dim ** 0.5
            a_logit = max_a[node.tap]
            logit_scale = scale_for(a_logit, 8)
            if logit_scale > logit_old * 2.0 ** (kb - 2):
                logit_scale = logit_old * 2.0 ** (kb - 2)
                a_logit = 127 / logit_scale
            lr, ls = derive_rescale_shift(np.float64(logit_old), logit_scale,
                                          kb)
            out_scale = _reachable(scale_for(max_a[node.out_tap], k), s, kb)
            orr, os_ = derive_rescale_shift(np.float64(s), out_scale, kb)
            attns[node.name] = AttnQ(node, s, int(lr), int(ls),
                                     exponent_lut(a_logit, 8), int(orr),
                                     int(os_))
            scale[node.dst], amax[node.dst] = float(out_scale), qmax
            scale[node.v_dst], amax[node.v_dst] = s, amax[node.src]
        elif isinstance(node, SplitNode):
            for d in (node.dst1, node.dst2):
                scale[d], amax[d] = scale[node.src], amax[node.src]
        elif isinstance(node, ResidualAddNode):
            requant(idx, node.src, scale[node.src], scale[node.base])
            scale[node.dst] = scale[node.base]
            amax[node.dst] = amax[node.src] + amax[node.base]
            n_res += 1
            if n_res == 3:
                clip_after[idx] = int(scale_for(1.0, k))
                amax[node.dst] = clip_after[idx]
        elif isinstance(node, ConcatNode):
            tgt = scale[node.scale_from]
            m = 0
            for e in node.srcs:
                if scale[e] != tgt:
                    requant(idx, e, scale[e], tgt)
                    m = max(m, qmax)
                else:
                    m = max(m, amax[e])
            scale[node.dst] = (scale[node.declared_scale_from]
                               if node.declared_scale_from else tgt)
            amax[node.dst] = m
        elif isinstance(node, (MaxPoolNode, UpsampleNode)):
            scale[node.dst], amax[node.dst] = scale[node.src], amax[node.src]

    box_scale = scale_for(cfg.dfl_max, 8)
    cls_scale = scale_for(cfg.cls_sigmoid_max, cfg.cls_sigmoid_bits)
    box_r, box_s, cls_r, cls_s = {}, {}, {}, {}
    for level, (up, dn) in HEAD_CONVS.items():
        box_r[level], box_s[level] = derive_rescale_shift(
            convs[up].acc_scale, box_scale, kb)
        cls_r[level], cls_s[level] = derive_rescale_shift(
            convs[dn].acc_scale, cls_scale, kb)
    dfl_w_q, dfl_w_scales = quant_matrix(np.asarray(params["dfl"]["w"]), k)
    dfl_acc_scale = float(127.0 * dfl_w_scales[0, 0])
    anchor_scale = scale_for(cfg.image_size / 8 - 1 + 0.5, 16)
    dfl_r, dfl_s = derive_rescale_shift(np.float64(dfl_acc_scale),
                                        anchor_scale, kb)
    head = HeadQ(box_r, box_s, cls_r, cls_s,
                 exp_lut=exponent_lut(cfg.dfl_max, 8),
                 cls_sig_lut=sigmoid_lut(cfg.cls_sigmoid_max,
                                         cfg.cls_sigmoid_bits),
                 dfl_w_q=dfl_w_q.reshape(16), dfl_r=int(dfl_r),
                 dfl_s=int(dfl_s), anchor_scale=float(anchor_scale))
    return QModel11(cfg, graph, convs, requants, amax, clip_after,
                    sigmoid_lut(cfg.sigmoid_lut_domain, k), head,
                    attns=attns)
