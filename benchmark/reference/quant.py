"""The integer constants of the quantized network, worked out again from the
fused float parameters and the calibration (``max_a``): the benchmark's
frozen copy of the arithmetic of alpha_yolo_quant_torch/quantize/
{primitives, luts, transform}.py, reduced to what fixes the integers
(weights, biases, per-edge scales, every rescale/shift pair, the LUTs, the
full-quant head). The program's fast-path eligibility flags and proven
edge ranges are left out: they choose kernels, not values.

Scale law, rounding idioms and requantization follow the hardware
contract: numpy half-to-even for weights, truncation for biases,
``clip(rhu((r * x) >> (s - 1)))`` for every requant.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from benchmark.reference.config import QuantConfig
from benchmark.reference.graph import (
    ConcatNode, ConvNode, Graph, MaxPoolNode, ResidualAddNode, SplitNode,
    UpsampleNode,
)


def scale_for(a, k: int):
    """Symmetric max-abs scale (2^(K-1)-1)/a."""
    return (2 ** (k - 1) - 1) / a


def quant_matrix(matrix: np.ndarray, k: int):
    """Per-output-channel symmetric quantization in the input's own dtype
    (float32 weights round in float32). Returns (int64, scales (O, 1))."""
    m = np.asarray(matrix)
    n = m.shape[0]
    scales = np.zeros((n, 1), np.float64)
    out = np.zeros(m.shape, np.int64)
    for i in range(n):
        a = np.abs(m[i]).max()
        s = (2 ** (k - 1) - 1) / a
        scales[i, 0] += s
        out[i] = np.int64(np.round(np.clip(m[i], -a, a) * s))
    return out, scales


def quant_bias(bias: np.ndarray, bias_scale) -> np.ndarray:
    """Bias quantization truncating toward zero."""
    return np.int64(np.asarray(bias, np.float64) * bias_scale)


def derive_rescale_shift(old_scale, new_scale, koeff_bits: int = 8):
    """(rescale, shift) for old_scale -> new_scale: shift = koeff_bits +
    floor(log2(old/new)), rescale = round(2^shift * new/old), one retry at
    shift - 1 when a rescale passes 2^koeff_bits - 1."""
    old = np.asarray(old_scale, np.float64)
    new = float(new_scale)
    limit = 2 ** koeff_bits - 1
    shift = koeff_bits + np.floor(np.log2(old / new))
    rescale = np.int64(np.round((2.0 ** shift) * (new / old)))
    if rescale.max() > limit:
        shift = shift - 1
        rescale = np.int64(np.round((2.0 ** shift) * (new / old)))
        if rescale.max() > limit:
            raise ValueError(f"rescale {rescale.max()} > {limit}")
    if np.any(shift < 1):
        raise ValueError(f"shift < 1: {shift}")
    return np.int64(rescale), np.int64(shift)


@dataclasses.dataclass(frozen=True)
class Lut:
    """Integer table over [lo, hi]; inputs outside map to 0."""

    lo: int
    hi: int
    values: np.ndarray          # int64


def _lut(fn, lo: int, hi: int, max_val: float, bits: int) -> Lut:
    """dequantize the index in float32 (divided in place), apply ``fn`` in
    float64, quantize with half-to-even rounding and clip."""
    qmax = 2 ** (bits - 1) - 1
    s = qmax / max_val
    vals = []
    for i in range(lo, hi + 1):
        d = np.array((i,)).astype(np.float32)
        d /= s
        f = np.array((fn(d[0]),))
        vals.append(np.clip(np.round(f * (qmax / 1)), -qmax, qmax)[0])
    return Lut(lo, hi, np.array(vals, np.float64).astype(np.int64))


def sigmoid_lut(max_val: float, bits: int) -> Lut:
    qmax = 2 ** (bits - 1) - 1
    return _lut(lambda d: 1 / (1 + np.e ** (-d)), -qmax, qmax, max_val, bits)


def exponent_lut(max_val: float, bits: int) -> Lut:
    return _lut(np.exp, -(2 ** bits - 1), 0, max_val, bits)


@dataclasses.dataclass
class ConvQ:
    node: ConvNode
    w_q: np.ndarray                 # int64 OIHW
    b_q: np.ndarray                 # int64 (O,)
    acc_scale: np.ndarray           # (O,) float64
    r1: Optional[np.ndarray] = None  # acc -> sigmoid domain
    s1: Optional[np.ndarray] = None
    r2: Optional[np.ndarray] = None  # sigma * acc -> output scale
    s2: Optional[np.ndarray] = None


@dataclasses.dataclass
class HeadQ:
    box_r: Dict[str, np.ndarray]
    box_s: Dict[str, np.ndarray]
    cls_r: Dict[str, np.ndarray]
    cls_s: Dict[str, np.ndarray]
    exp_lut: Lut
    cls_sig_lut: Lut
    dfl_w_q: np.ndarray             # (16,) int64
    dfl_r: int
    dfl_s: int
    anchor_scale: float


@dataclasses.dataclass
class QModel:
    cfg: QuantConfig
    graph: Graph
    convs: Dict[str, ConvQ]
    requants: Dict[Tuple[int, str], Tuple[int, int]]
    edge_amax: Dict[str, int]       # integer magnitude bound per edge
    clip_after_residual: Dict[int, int]
    sig_lut: Lut
    head: HeadQ


HEAD_CONVS = {"p3": ("x_result_5_up_2", "x_result_5_down_2"),
              "p4": ("x_result_6_up_2", "x_result_6_down_2"),
              "p5": ("x_up_2", "x_down_2")}


def quantize_model(graph: Graph, params: Dict, max_a: Dict[str, float],
                   cfg: QuantConfig) -> QModel:
    """Every integer constant of the full-quant network from fused float
    params and the calibration."""
    if not cfg.full_quant:
        raise ValueError("the reference serves the full-quant pipeline")
    k, qmax, kb = cfg.k, cfg.qmax, cfg.koeff_bits
    sig_scale = scale_for(cfg.sigmoid_lut_domain, k)
    scale = {graph.input_edge: scale_for(1.0, k)}
    amax = {graph.input_edge: qmax}
    convs: Dict[str, ConvQ] = {}
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
                out_s = scale_for(max_a[node.out_tap], k)
                old2 = scale_for(1.0, k) * acc_scale
                # an output scale the 8-bit rescale cannot reach is clamped
                # to the largest one it can
                out_s = min(out_s, float(np.min(old2)) * 2.0 ** (kb - 2))
                c.r1, c.s1 = derive_rescale_shift(acc_scale, sig_scale, kb)
                c.r2, c.s2 = derive_rescale_shift(old2, out_s, kb)
                scale[node.dst] = float(out_s)
                amax[node.dst] = qmax
            else:
                scale[node.dst] = float("nan")
                amax[node.dst] = 0
            convs[node.name] = c
        elif isinstance(node, SplitNode):
            for d in (node.dst1, node.dst2):
                scale[d], amax[d] = scale[node.src], amax[node.src]
        elif isinstance(node, ResidualAddNode):
            requant(idx, node.src, scale[node.src], scale[node.base])
            scale[node.dst] = scale[node.base]
            amax[node.dst] = amax[node.src] + amax[node.base]
            n_res += 1
            if n_res == 3:
                # the full-quant contract clips the third residual sum
                # (the second of C2F_4) back to +-int(scale(1, K))
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
    return QModel(cfg, graph, convs, requants, amax, clip_after,
                  sigmoid_lut(cfg.sigmoid_lut_domain, k), head)
