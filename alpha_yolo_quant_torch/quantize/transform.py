"""The float->integer graph transform: builds the complete quantized model
(integer weights/biases, per-edge scales, every rescale/shift constant) as
host-side numpy, bit-exact with the reference pipeline's derivation.

This is the stage-5/6 analog (reference stage_6.py:88-165 `conv_quant`/
`silu_quant`, plus the structural requants threaded through
stage_6.py:187-596), except the scale flow is computed over the graph IR
instead of being hand-positioned in a 600-line script.

Scale algebra (see SURVEY.md §2.3):
  * edge scales are SCALARS: every SiLU output is requantized to
    scale(max_a[out_tap], K); split/pool/upsample preserve scale; residual
    and concat unify scales by explicit requantization.
  * conv accumulators carry PER-CHANNEL scales s_acc = s_in * w_scale.
  * SiLU path: requant1(acc -> sigmoid domain), LUT, multiply by the raw
    accumulator, requant2(sigma*acc -> next input scale). At runtime
    requant2's multiplier is folded: m = sigma_q * rescale2 < 2^15.

The port's own copy of alpha_yolo_quant_tpu/quantize/transform.py: the
same numpy derivation, so both packages build equal models from the same
params and calibration. The fast-path flags of ConvPlan and HeadPlan
(bigshift_ok, bf16_*, fold*_ok, *direct_ok) describe the JAX engines'
int32 and bf16 forms; the port computes every requant in int64 and every
conv exactly in int32, so it reads none of them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.models.graph import (
    ConcatNode, ConvNode, Graph, MaxPoolNode, ResidualAddNode, SplitNode,
    UpsampleNode,
)
from alpha_yolo_quant_torch.quantize.luts import Lut, exponent_lut, sigmoid_lut
from alpha_yolo_quant_torch.quantize.primitives import (
    derive_rescale_shift, quant_bias, quant_matrix, scale_for,
)

I15_MAX = 1 << 15   # the folded requant's multiplier bound (m < 2^15)


@dataclasses.dataclass
class ConvPlan:
    """Quantized conv (+ fused SiLU) parameters."""

    node: ConvNode
    w_q: np.ndarray                 # int K-bit values in int32
    b_q: np.ndarray                 # int32 (bias budget 18 bits, checked)
    in_scale: float                 # scalar input scale
    w_scales: np.ndarray            # (C_out,) float64
    acc_scale: np.ndarray           # (1, C_out, 1, 1) float64
    # SiLU constants (None for the plain head convs):
    r1: Optional[np.ndarray] = None  # (1,C,1,1) int32: acc -> sigmoid domain
    s1: Optional[np.ndarray] = None
    r2: Optional[np.ndarray] = None  # (1,C,1,1) int32: sigma*acc -> out scale
    s2: Optional[np.ndarray] = None
    out_scale: Optional[float] = None
    # both requant shifts >= 16 -> the fast bigshift formulation applies
    # (ops/intmath.requantize_i32_bigshift)
    bigshift_ok: bool = False
    # per-output accumulation < 2^24 -> single-pass bf16 conv is exact
    # (ops/nn.conv2d_bf16_exact); measured faster than s8 on stride-1 and
    # 1x1 layers on v5e
    bf16_single_ok: bool = False
    # Offset-folded single-pass bf16 conv for WIDE input edges
    # (|v| can exceed 256, where odd bf16 ints round): when the PROVEN
    # signed range [edge_lo, edge_hi] of the input edge has width
    # <= 512 and the conv has padding 0, the engine may compute
    # conv(x - c) + (b + c*sum(w)) with c = edge_hi - 256 — every
    # shifted input is an integer in [-256, 256] (bf16-exact) and the
    # bias fold is exact because no padded zeros exist. Bit-identical
    # accumulator by linearity; 1.83 ms/batch faster than the 3-part
    # s8 split on the one K=8 wide-edge conv (scripts/r7_wideedge3.log).
    # None = not eligible.
    bf16_offset: Optional[int] = None
    # per-out-channel true accumulator bound max|conv(x,w)+b| (int64)
    acc_bound: Optional[np.ndarray] = None
    # Requant fast paths proven in-int32-range against acc_bound (see
    # ops/intmath.py for the identities + preconditions; selected by the
    # runtime epilogue — all bit-exact):
    req1_direct_ok: bool = False   # acc->sigdom via one multiply
    fold1_ok: bool = False         # folded-rhu bigshift, first requant
    fold2_ok: bool = False         # folded-rhu bigshift, second requant


@dataclasses.dataclass
class RequantPlan:
    """Scalar structural requantization (residual / concat input)."""

    rescale: int
    shift: int
    old_scale: float
    new_scale: float


@dataclasses.dataclass
class HeadPlan:
    """Full-quant head constants (reference stage_6_full_quant diff;
    see SURVEY.md §2.3.7-8)."""

    box_r: Dict[str, np.ndarray]       # per level: (1,C,1,1) int32
    box_s: Dict[str, np.ndarray]
    box_scale: float                   # scale(dfl_max, K)
    cls_r: Dict[str, np.ndarray]
    cls_s: Dict[str, np.ndarray]
    cls_scale: float                   # scale(cls_sigmoid_max, 16)
    exp_lut: Lut
    cls_sigmoid_lut: Lut
    dfl_w_q: np.ndarray                # int32 (1,16,1,1)
    dfl_acc_scale: float               # 127 * dfl_w_scale
    dfl_r: int                         # dfl acc -> anchor scale (16-bit)
    dfl_s: int
    anchor_scale: float
    # requant fast-path eligibility per "p{3,4,5}_{box,cls}" role vs the
    # head conv's true accumulator bound (ops/intmath.py preconditions)
    req_direct_ok: Dict[str, bool] = dataclasses.field(default_factory=dict)
    req_fold_ok: Dict[str, bool] = dataclasses.field(default_factory=dict)
    # DFL accumulator requant: |acc| <= 16 taps * 127 probs * max|w|
    dfl_direct_ok: bool = False


@dataclasses.dataclass
class QuantizedModel:
    cfg: QuantConfig
    graph: Graph
    max_a: Dict[str, float]
    convs: Dict[str, ConvPlan]                    # by ConvNode.name
    requants: Dict[Tuple[int, str], RequantPlan]  # (node index, src edge)
    edge_scale: Dict[str, float]
    edge_amax_int: Dict[str, int]                 # integer magnitude bound
    sig_lut: Lut
    head: Optional[HeadPlan] = None
    clip_after_residual: Dict[int, int] = dataclasses.field(
        default_factory=dict)                     # node idx -> clip bound
    # PROVEN signed per-edge integer bounds (worst case over any input,
    # from the exact LUT-epilogue range of each SiLU layer propagated
    # through splits/residuals/concats/pools) — tighter than the
    # symmetric edge_amax_int on residual chains because integer SiLU
    # outputs are heavily asymmetric (min ~ -0.2785/out_scale vs max
    # qmax). Drives ConvPlan.bf16_offset eligibility only; all
    # existing machinery keys off edge_amax_int unchanged.
    edge_lo: Dict[str, int] = dataclasses.field(default_factory=dict)
    edge_hi: Dict[str, int] = dataclasses.field(default_factory=dict)


class PlanError(RuntimeError):
    pass


def _fold_ok(m: np.ndarray, s: np.ndarray, bound: np.ndarray) -> bool:
    """Folded-rhu bigshift precondition (requantize_i32_bigshift_folded):
    per channel, floor(m*bound/2^15) + 1 + 2^(s-16) < 2^31 with s >= 16,
    AND m < 2^15 — the widening decomposition t = m*a_h + (m*a_l >> 15)
    needs m*a_h and m*a_l to fit int32 for ANY int32 x (a_l reaches
    0x7FFF for every negative x regardless of acc_bound). m stays below
    2^15 today (m_max = r2*sigma_max <= 255*127 = 32385 at koeff_bits=8,
    K<=8) but this is a config-dependent margin of only 383."""
    m, s, bound = np.int64(m).reshape(-1), np.int64(s).reshape(-1), \
        np.int64(bound).reshape(-1)
    if s.min() < 16 or m.max() >= I15_MAX:
        return False
    t_max = (m * bound >> 15) + 1
    return bool(np.all(t_max + (np.int64(1) << (s - 16)) < 2 ** 31))


def _direct_ok(m: np.ndarray, s: np.ndarray, bound: np.ndarray) -> bool:
    """Single-multiply requant precondition (requantize_i32_direct):
    per channel, m*bound + 2^(s-1) < 2^31."""
    m, s, bound = np.int64(m).reshape(-1), np.int64(s).reshape(-1), \
        np.int64(bound).reshape(-1)
    return bool(np.all(m * bound + (np.int64(1) << (s - 1)) < 2 ** 31))


def _check_accumulator_bounds(node: ConvNode, w_q: np.ndarray,
                              b_q: np.ndarray, in_amax: int) -> None:
    """int32 accumulator + exact-bf16-conv preconditions
    (see ops/nn.py conv2d_int_exact)."""
    wabs = np.abs(w_q.reshape(w_q.shape[0], -1)).sum(axis=1)  # per out-chan
    acc_bound = wabs * in_amax + np.abs(b_q)
    if acc_bound.max() >= 2 ** 31:
        raise PlanError(f"{node.name}: int32 accumulator overflow "
                        f"({acc_bound.max():.3g})")
    # nibble-split partials accumulate |w|*|x part| per tap in f32 (exact
    # < 2^24); |x>>4| <= (amax>>4)+1 and |x&15| <= 15. int8 inputs give the
    # historical bound 16; 381-wide concat edges give 24.
    hi_mag = max((in_amax >> 4) + 1, 15)
    part_bound = wabs * hi_mag
    if part_bound.max() >= 2 ** 24:
        raise PlanError(f"{node.name}: bf16-split partial overflow "
                        f"({part_bound.max():.3g})")


def _rhu_shift_np(p: np.ndarray, s: np.ndarray) -> np.ndarray:
    """round-half-up(p / 2^s) exactly as every runtime requant computes
    it (ops/intmath.py, primitives.requantize_np): q = p >> (s-1)
    (arithmetic floor shift), then q//2 + q%2. int64 host math.
    Nondecreasing in p for fixed s."""
    q = np.right_shift(np.int64(p), np.int64(s) - 1)
    return (q >> 1) + (q & 1)


def silu_out_range(plan: "ConvPlan", sig: Lut, qmax: int):
    """EXACT signed range of a SiLU layer's integer output over every
    possible accumulator value acc in [-acc_bound_c, acc_bound_c].

    The epilogue (interpreter.finish_conv; all proven-equal fast paths
    compute identical bits) is
        dom = clip(rhu((r1*acc) >> (s1-1)), +-qmax)
        y   = clip(rhu((sigma[dom]*r2*acc) >> (s2-1)), +-qmax)
    with sigma >= 0 (sigmoid LUT values are nonnegative). Within a dom
    bin the multiplier is a fixed nonnegative constant, so y is
    nondecreasing in acc there; dom itself is a nondecreasing step
    function of acc. Extremes therefore occur at BIN-EDGE accs, and the
    bins invert in closed form: writing q1 = floor(r1*acc / 2^(s1-1)),
    rhu(q1) == d  iff  q1 in {2d-1, 2d}, so the unclipped bin for d is
        acc in [ ceil((2d-1)*2^(s1-1)/r1),  ceil((2d+1)*2^(s1-1)/r1) - 1 ]
    (the d = +-qmax bins additionally swallow everything the clip
    catches). Evaluating y at both edges of every nonempty bin
    (intersected with [-acc_bound, acc_bound]) yields the exact min/max.

    Returns (lo, hi) python ints over all channels; acc = 0 (y = 0) is
    always attainable so 0 is in [lo, hi]. Falls back to the trivial
    (-qmax, qmax) when the closed-form inversion could overflow int64
    (s1 > 54; never seen — s1 is ~15-30 at koeff_bits=8) or a rescale
    is degenerate. Validated by exhaustion and against the runtime in
    tests/test_wide_offset.py.
    """
    r1 = np.int64(plan.r1).reshape(-1)
    s1 = np.int64(plan.s1).reshape(-1)
    r2 = np.int64(plan.r2).reshape(-1)
    s2 = np.int64(plan.s2).reshape(-1)
    ab = np.int64(plan.acc_bound).reshape(-1)
    if s1.max() > 54 or r1.min() < 1 or r2.min() < 0 or s2.min() < 1:
        return -qmax, qmax
    sigv = np.int64(sig.values)
    half = np.int64(1) << (s1 - 1)
    lo_best = np.zeros_like(ab)
    hi_best = np.zeros_like(ab)
    for d in range(-qmax, qmax + 1):
        if d == -qmax:
            a_lo = -ab
        else:
            num = np.int64(2 * d - 1) * half
            a_lo = -((-num) // r1)               # ceil(num / r1)
        if d == qmax:
            a_hi = ab
        else:
            num2 = np.int64(2 * d + 1) * half
            a_hi = -((-num2) // r1) - 1
        a_lo = np.maximum(a_lo, -ab)
        a_hi = np.minimum(a_hi, ab)
        valid = a_lo <= a_hi
        if not valid.any():
            continue
        m = sigv[d - sig.lo] * r2                # |m*acc| < 2^15*2^31: safe
        for a in (a_lo, a_hi):
            y = np.clip(_rhu_shift_np(m * a, s2), -qmax, qmax)
            lo_best = np.where(valid, np.minimum(lo_best, y), lo_best)
            hi_best = np.where(valid, np.maximum(hi_best, y), hi_best)
    return int(lo_best.min()), int(hi_best.max())


def _requant_range(lo: int, hi: int, r: int, s: int, qmax: int):
    """Signed range through requantize_i32_small (monotone in x, so the
    endpoints map; clipped to +-qmax)."""
    lo_q = int(np.clip(_rhu_shift_np(np.int64(r) * lo, s), -qmax, qmax))
    hi_q = int(np.clip(_rhu_shift_np(np.int64(r) * hi, s), -qmax, qmax))
    return lo_q, hi_q


def build_quantized_model(graph: Graph, params: Dict,
                          max_a: Dict[str, float],
                          cfg: Optional[QuantConfig] = None,
                          bias_warn=None,
                          weights_override: Optional[Dict] = None,
                          dfl_override=None
                          ) -> QuantizedModel:
    """Derive every integer constant of the quantized network.

    params: fused float params; max_a: calibration dict (tap -> max-abs).
    weights_override: conv name -> (w_q, b_q, acc_scale) to rebuild a plan
    from STORED integer artifacts (the stage-8 load path) — every requant
    constant derives from acc_scale + max_a, so the loaded plan is
    bit-identical to the built one.
    dfl_override: (dfl_w_q ints, dfl_acc_scale float) for the full-quant
    head when rebuilding from stored artifacts: the reference's packed
    state dict carries the QUANTIZED dfl weights (stage_7.py:762-780 maps
    the mtime-last dfl_conv.pickle onto 'dfl.weight') and its deployed
    runtime reads the scale from bias_scales/dfl_scale.pickle
    (stage_8_torch_full_quant.py:1233), so the float dfl is not
    recoverable — the plan must take both stored values as-is.
    """
    cfg = cfg or graph.cfg
    k = cfg.k
    qmax = cfg.qmax
    sig_dom = cfg.sigmoid_lut_domain
    sig_scale = scale_for(sig_dom, k)

    sig = sigmoid_lut(sig_dom, k)

    edge_scale: Dict[str, float] = {
        graph.input_edge: scale_for(1.0, k)}     # start=True pins a=1
    edge_amax: Dict[str, int] = {graph.input_edge: qmax}
    # proven signed bounds (see QuantizedModel.edge_lo/edge_hi)
    edge_lo_d: Dict[str, int] = {graph.input_edge: -qmax}
    edge_hi_d: Dict[str, int] = {graph.input_edge: qmax}
    convs: Dict[str, ConvPlan] = {}
    requants: Dict[Tuple[int, str], RequantPlan] = {}
    clip_after: Dict[int, int] = {}

    def scalar_requant(idx, src, old, new):
        r, s = derive_rescale_shift(np.float64(old), float(new),
                                    cfg.koeff_bits)
        if np.ndim(r):
            raise PlanError("structural requant must be scalar")
        requants[(idx, src)] = RequantPlan(int(r), int(s), float(old),
                                           float(new))

    n_residuals_seen = 0
    for idx, node in enumerate(graph.nodes):
        if isinstance(node, ConvNode):
            in_s = edge_scale[node.src]
            if weights_override and node.name in weights_override:
                w_q, b_q, acc_scale = weights_override[node.name]
                w_q = np.int64(w_q)
                b_q = np.int64(b_q).reshape(-1)
                acc_scale = np.asarray(acc_scale, np.float64).reshape(
                    1, -1, 1, 1)
                w_scales = (acc_scale.reshape(-1) / in_s)[:, None]
            else:
                p = params[node.key]
                # dtype-native: the reference quantizes the f32 state dict
                # in f32 (see primitives.quant_matrix docstring)
                w_q, w_scales = quant_matrix(np.asarray(p["w"]), k)
                bias_scale = (in_s * w_scales[:, 0])      # (C_out,)
                b_q = quant_bias(np.asarray(p["b"], np.float64), bias_scale)
                acc_scale = bias_scale.reshape(1, -1, 1, 1)
            if np.abs(b_q).max() >= 2 ** (cfg.bias_bits - 1) and bias_warn:
                bias_warn(node.name, int(np.abs(b_q).max()))
            _check_accumulator_bounds(node, w_q, b_q, edge_amax[node.src])
            wabs = np.abs(np.int64(w_q).reshape(w_q.shape[0], -1)).sum(1)
            # single-pass bf16 conv needs (a) the f32 accumulation bound AND
            # (b) every input exactly representable in bf16 — integers up to
            # 256 only (8-bit mantissa); chained-residual concat edges reach
            # 381, where odd values > 256 would round silently.
            acc_bound = wabs * edge_amax[node.src] + np.abs(np.int64(b_q))
            bf16_ok = bool(acc_bound.max() < 2 ** 24
                           and edge_amax[node.src] <= 256)
            plan = ConvPlan(node=node, w_q=w_q.astype(np.int32),
                            b_q=b_q.astype(np.int32), in_scale=float(in_s),
                            w_scales=w_scales[:, 0], acc_scale=acc_scale,
                            bf16_single_ok=bf16_ok, acc_bound=acc_bound)
            if (not bf16_ok and node.padding == 0
                    and edge_amax[node.src] > 256):
                # offset-folded bf16 eligibility (ConvPlan.bf16_offset
                # docstring): proven signed input range of width <= 512
                # shifts into bf16's exact-integer window; pad == 0
                # keeps the c*sum(w) bias fold exact (no padded zeros)
                elo, ehi = edge_lo_d[node.src], edge_hi_d[node.src]
                if ehi - elo <= 512:
                    c_off = ehi - 256    # [elo-c, 256] within [-256, 256]
                    sw = np.int64(w_q).reshape(w_q.shape[0], -1).sum(1)
                    b_eff = np.int64(b_q) + c_off * sw
                    if (wabs * 256 + np.abs(b_eff)).max() < 2 ** 24:
                        plan.bf16_offset = int(c_off)
            if node.silu:
                a_out = max_a[node.out_tap]
                out_s = scale_for(a_out, k)
                # Requantization feasibility: with an 8-bit rescale budget,
                # shift = koeff_bits + floor(log2(old/new)) must stay >= 1
                # (after the possible retry at shift-1). The reference
                # simply exit()s when the budget is blown
                # (utils/rescale_coeff.py:40-42); we clamp the calibrated
                # output scale to the representable range and warn.
                old2 = scale_for(1.0, k) * acc_scale
                feas = float(np.min(old2)) * 2.0 ** (cfg.koeff_bits - 2)
                if out_s > feas:
                    if bias_warn:
                        bias_warn(f"{node.name}: calibrated a={a_out:.4g} "
                                  "requant-infeasible; clamping", 0)
                    out_s = feas
                r1, s1 = derive_rescale_shift(acc_scale, sig_scale,
                                              cfg.koeff_bits)
                r2, s2 = derive_rescale_shift(old2, out_s, cfg.koeff_bits)
                if np.any(np.int64(s1) < 1) or np.any(np.int64(s2) < 1):
                    raise PlanError(f"{node.name}: shift<1")
                plan.r1 = np.int64(r1).astype(np.int32)
                plan.s1 = np.int64(s1).astype(np.int32)
                plan.r2 = np.int64(r2).astype(np.int32)
                plan.s2 = np.int64(s2).astype(np.int32)
                plan.bigshift_ok = bool(plan.s1.min() >= 16 and
                                        plan.s2.min() >= 16)
                # requant fast-path eligibility vs the TRUE accumulator
                # bound (ops/intmath.py preconditions; the epilogue's
                # second requant folds sigma into the multiplier, so its
                # magnitude bound is r2 * max(sigma table))
                plan.req1_direct_ok = _direct_ok(plan.r1, plan.s1,
                                                 acc_bound)
                plan.fold1_ok = _fold_ok(plan.r1, plan.s1, acc_bound)
                plan.fold2_ok = _fold_ok(
                    np.int64(plan.r2).reshape(-1)
                    * int(np.int64(sig.values).max()),
                    plan.s2, acc_bound)
                plan.out_scale = float(out_s)
                edge_scale[node.dst] = float(out_s)
                edge_amax[node.dst] = qmax
                edge_lo_d[node.dst], edge_hi_d[node.dst] = \
                    silu_out_range(plan, sig, qmax)
            else:
                # plain head conv: dst carries the raw int32 accumulator
                edge_scale[node.dst] = float("nan")
                edge_amax[node.dst] = 0
                bound = int(acc_bound.max())
                edge_lo_d[node.dst], edge_hi_d[node.dst] = -bound, bound
            convs[node.name] = plan
        elif isinstance(node, SplitNode):
            edge_scale[node.dst1] = edge_scale[node.dst2] = \
                edge_scale[node.src]
            edge_amax[node.dst1] = edge_amax[node.dst2] = edge_amax[node.src]
            edge_lo_d[node.dst1] = edge_lo_d[node.dst2] = edge_lo_d[node.src]
            edge_hi_d[node.dst1] = edge_hi_d[node.dst2] = edge_hi_d[node.src]
        elif isinstance(node, ResidualAddNode):
            old, new = edge_scale[node.src], edge_scale[node.base]
            scalar_requant(idx, node.src, old, new)
            edge_scale[node.dst] = new
            edge_amax[node.dst] = edge_amax[node.src] + edge_amax[node.base]
            rq = requants[(idx, node.src)]
            rlo, rhi = _requant_range(edge_lo_d[node.src],
                                      edge_hi_d[node.src],
                                      rq.rescale, rq.shift, qmax)
            edge_lo_d[node.dst] = rlo + edge_lo_d[node.base]
            edge_hi_d[node.dst] = rhi + edge_hi_d[node.base]
            n_residuals_seen += 1
            if cfg.full_quant and n_residuals_seen == 3:
                # The reference full-quant pipeline clips ONLY the second
                # C2F_4 residual sum (C2F_4_bottle_3_SUMM) back to
                # +-int(scale(1,K)) (stage_6_full_quant.py:322). That is the
                # 3rd residual overall: C2F_2 has one, C2F_4 two.
                bound = int(scale_for(1.0, k))
                clip_after[idx] = bound
                edge_amax[node.dst] = bound
                edge_lo_d[node.dst] = max(edge_lo_d[node.dst], -bound)
                edge_hi_d[node.dst] = min(edge_hi_d[node.dst], bound)
        elif isinstance(node, ConcatNode):
            tgt = edge_scale[node.scale_from]
            amax = 0
            clo, chi = qmax, -qmax
            for e in node.srcs:
                if edge_scale[e] != tgt:
                    scalar_requant(idx, e, edge_scale[e], tgt)
                    amax = max(amax, qmax)
                    rq = requants[(idx, e)]
                    rlo, rhi = _requant_range(edge_lo_d[e], edge_hi_d[e],
                                              rq.rescale, rq.shift, qmax)
                else:
                    amax = max(amax, edge_amax[e])
                    rlo, rhi = edge_lo_d[e], edge_hi_d[e]
                clo, chi = min(clo, rlo), max(chi, rhi)
            # full-quant stale-scale quirk: the reference requantizes the
            # data to `scale_from`'s scale but hands the consumer the
            # OTHER participant's scale variable (see ConcatNode docs)
            edge_scale[node.dst] = edge_scale[node.declared_scale_from] \
                if node.declared_scale_from else tgt
            edge_amax[node.dst] = amax
            edge_lo_d[node.dst], edge_hi_d[node.dst] = clo, chi
        elif isinstance(node, (MaxPoolNode, UpsampleNode)):
            edge_scale[node.dst] = edge_scale[node.src]
            edge_amax[node.dst] = edge_amax[node.src]
            edge_lo_d[node.dst] = edge_lo_d[node.src]
            edge_hi_d[node.dst] = edge_hi_d[node.src]

    model = QuantizedModel(cfg=cfg, graph=graph, max_a=dict(max_a),
                           convs=convs, requants=requants,
                           edge_scale=edge_scale, edge_amax_int=edge_amax,
                           sig_lut=sig, clip_after_residual=clip_after,
                           edge_lo=edge_lo_d, edge_hi=edge_hi_d)
    if cfg.full_quant:
        model.head = _build_head_plan(graph, params, convs, cfg,
                                      dfl_override=dfl_override)
    return model


def _anchor_max(image_size: int) -> float:
    """Max anchor coordinate: largest grid index + 0.5 on the stride-8 level
    (79.5 at 640; reference hard-codes np.max(anchor))."""
    return image_size / 8 - 1 + 0.5


def _build_head_plan(graph: Graph, params: Dict, convs: Dict[str, ConvPlan],
                     cfg: QuantConfig, dfl_override=None) -> HeadPlan:
    # The reference full-quant head is pinned to 8-bit box / 16-bit cls math
    # regardless of the backbone K (stage_6_full_quant: requant_last_layers
    # (..., 8), create_exponent_lookup_table(14.826..., 8), softmax * 127,
    # create_sigmoid_lookup_table(12, 16)); dfl weights use the backbone K.
    box_scale = scale_for(cfg.dfl_max, 8)
    cls_scale = scale_for(cfg.cls_sigmoid_max, cfg.cls_sigmoid_bits)
    box_r, box_s, cls_r, cls_s = {}, {}, {}, {}
    direct_ok, fold_ok = {}, {}
    for level, head_name in (("p3", "x_result_5"), ("p4", "x_result_6"),
                             ("p5", "x")):
        upn = f"{head_name}_up_2" if head_name != "x" else "x_up_2"
        dnn = f"{head_name}_down_2" if head_name != "x" else "x_down_2"
        up_plan = convs[upn]
        dn_plan = convs[dnn]
        r, s = derive_rescale_shift(up_plan.acc_scale, box_scale,
                                    cfg.koeff_bits)
        box_r[level] = np.int64(r).astype(np.int32)
        box_s[level] = np.int64(s).astype(np.int32)
        direct_ok[f"{level}_box"] = _direct_ok(r, s, up_plan.acc_bound)
        fold_ok[f"{level}_box"] = _fold_ok(r, s, up_plan.acc_bound)
        r, s = derive_rescale_shift(dn_plan.acc_scale, cls_scale,
                                    cfg.koeff_bits)
        cls_r[level] = np.int64(r).astype(np.int32)
        cls_s[level] = np.int64(s).astype(np.int32)
        direct_ok[f"{level}_cls"] = _direct_ok(r, s, dn_plan.acc_bound)
        fold_ok[f"{level}_cls"] = _fold_ok(r, s, dn_plan.acc_bound)

    exp = exponent_lut(cfg.dfl_max, 8)
    cls_sig = sigmoid_lut(cfg.cls_sigmoid_max, cfg.cls_sigmoid_bits)

    if dfl_override is not None:
        # stored-artifact rebuild: ints + scale as-is (see
        # build_quantized_model docstring)
        dfl_w_q = np.int64(dfl_override[0]).reshape(1, 16, 1, 1)
        dfl_acc_scale = float(dfl_override[1])
    else:
        dfl_w = np.asarray(params["dfl"]["w"])   # dtype-native (reference
        dfl_w_q, dfl_w_scales = quant_matrix(dfl_w, cfg.k)  # dfl_quant:129)
        dfl_acc_scale = float(127.0 * dfl_w_scales[0, 0])  # softmax scl 127
    anchor_scale = scale_for(_anchor_max(cfg.image_size), 16)
    r, s = derive_rescale_shift(np.float64(dfl_acc_scale), anchor_scale,
                                cfg.koeff_bits)
    # DFL acc = sum over 16 bins of p (in [0,127]) * w_q — true bound
    dfl_bound = int(127 * np.abs(np.int64(dfl_w_q)).sum())
    dfl_dir = _direct_ok(np.int64(r), np.int64(s), np.int64(dfl_bound))
    return HeadPlan(box_r=box_r, box_s=box_s, box_scale=float(box_scale),
                    cls_r=cls_r, cls_s=cls_s, cls_scale=float(cls_scale),
                    exp_lut=exp, cls_sigmoid_lut=cls_sig,
                    dfl_w_q=dfl_w_q.astype(np.int32),
                    dfl_acc_scale=dfl_acc_scale,
                    dfl_r=int(r), dfl_s=int(s),
                    anchor_scale=float(anchor_scale),
                    req_direct_ok=direct_ok, req_fold_ok=fold_ok,
                    dfl_direct_ok=dfl_dir)
