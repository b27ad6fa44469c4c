"""Slab-resident integer forward: the ``packed`` engine's planner and
executor (counterpart of alpha_yolo_quant_tpu/runtime/slabforward.py).

The narrow-channel region of the network stays lane-packed
(runtime/packed_conv.py) from conv to conv, because every structural op
between the convs is linear over channels and can live in the tap
matrices instead of in data movement:

* an edge's value is a sum of CONTRIBUTIONS — (slab, src channel range,
  logical channel range) triples.  A conv over the edge builds one
  banded tap-matrix set per contributing slab; the weight-column slice
  encodes where the contribution sits in the conv's input space.
* `Split` is bookkeeping: the halves are channel ranges of the source
  contributions.
* `Concat` is bookkeeping: contributions shifted in logical space.  The
  consuming conv reads k slabs instead of one (conv(concat(xs)) ==
  sum_i conv_i(x_i)); the wide concat edges never materialize.
* `ResidualAdd` is lazy: `requant(x) + base` carries the requantized
  slab and the base's contributions side by side; the consumer sums
  them in its int32 accumulator (exact in two's complement, any order).
  Only the reference's explicit residual CLIP forces a materialize
  (sum, clip, re-split into int8 parts).
* `Upsample x2` on a 1-pixel-per-group slab duplicates rows/groups.

Stride-2 convs read even/odd row-block views of the producer's slab, and
coarser-packed contributions into a 1x1 conv enter via even/odd GROUP
views (the down-pack geometry of packed_conv.make_down2_plan generalized
to any contribution).

The planner (``build_slab_plan`` and its IR) is the port's own copy of
the JAX module's numpy code, logic unchanged, so both packages plan the
same ops, taps, matrices and lanes. ``SlabExec`` runs the plan on torch
tensors: every conv through the banded kernel (packed_conv.packed_call),
the glue between them as torch slicing and the port's integer requants.
It reads and writes the interpreter's NHWC environment, whose store type
is int16 on the wide edges and int8 elsewhere. In the planner's comments
"XLA" names that environment path: in the port, the per-conv kernels
(conv1x1/conv3x3) and torch glue.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from alpha_yolo_quant_torch.models.graph import (
    ConcatNode, ConvNode, MaxPoolNode, ResidualAddNode, SplitNode,
    UpsampleNode,
)
from alpha_yolo_quant_torch.ops.intmath import requantize_small
from alpha_yolo_quant_torch.runtime import packed_conv as pc

FRONT_PAD = pc.FRONT_PAD
SUBLANE_PAD = pc.SUBLANE_PAD


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Geom:
    """Lane geometry of a slab: p pixels x c_slot channels per 128-lane
    group, g groups per image row, h data rows."""
    c_slot: int
    p: int
    g: int
    h: int

    @property
    def gp2(self) -> int:
        return self.g + 2

    @property
    def rows(self) -> int:
        return (self.h + 2) * self.gp2

    @property
    def rows_ext(self) -> int:
        r = FRONT_PAD + self.rows + self.gp2 + SUBLANE_PAD
        return -(-r // 32) * 32


@dataclasses.dataclass(frozen=True)
class CPlan:
    """A contribution: channels [src_c0, src_c0+n_ch) of `key`'s per-
    pixel slot hold logical channels [dst_c0, dst_c0+n_ch)."""
    key: str
    geom: Geom
    src_c0: int
    n_ch: int
    dst_c0: int


# ---------------------------------------------------------------------------
# ops (exec IR)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PackOp:
    """NCHW env edge -> int8 slab(s); one key per int8 part and per
    128-channel block (keys f"{key}", or f"{key}+{i}" for extras)."""
    keys: List[str]
    env_edge: str
    geom: Geom
    c0: int            # channel block start in the env tensor
    n_ch: int
    n_parts: int


@dataclasses.dataclass
class ConvOp:
    name: str
    key: str                       # output slab key
    taps: List[Tuple[str, int, int]]   # (slab key / derived key, w, base)
    wlist: List[np.ndarray]
    geom: Geom                     # output geometry
    out_c0: int
    h_out: int
    silu: bool


@dataclasses.dataclass
class EwReqOp:
    """Elementwise structural requant of a whole slab (requant(0)==0, so
    pad rows and unused lanes stay zero)."""
    key: str
    src_key: str
    rq: Tuple[int, str]            # plan["requants"] key


@dataclasses.dataclass
class MatOp:
    """Materialize an aligned lazy sum: sum int8 slabs in int32, apply
    the optional residual clip, then re-split into int8 parts."""
    keys: List[str]
    src_keys: List[str]
    clip_bound: Optional[int]
    rq: Optional[Tuple[int, str]]  # fused requant instead of part split


@dataclasses.dataclass
class UpsampleOp:
    key: str
    src_key: str
    geom_in: Geom                  # p == 1


@dataclasses.dataclass
class UnpackOp:
    env_edge: str
    contribs: List[CPlan]
    c: int
    h: int
    w: int
    wide: bool                     # int16 env dtype (else int8)


@dataclasses.dataclass
class SlabPlan:
    pre_ops: Dict[int, list]       # ops to run BEFORE interpreter node idx
    node_ops: Dict[int, list]      # ops replacing interpreter node idx
    nodes: set                     # node idxs fully slab-handled
    lanes: Dict[str, dict]         # conv name -> packed epilogue lanes
    geoms: Dict[str, Geom]         # slab key -> geometry
    n_convs: int


# ---------------------------------------------------------------------------
# tap-matrix construction
# ---------------------------------------------------------------------------


def _emit_taps(acc: Dict[Tuple[str, int], np.ndarray], w4: np.ndarray,
               ct: CPlan, go: Geom, out_c0: int, stride: int,
               kernel: int) -> None:
    """Accumulate the banded matrices for one contribution into
    `acc[(slab_key, row_base)] -> (128,128) int64`.

    w4: (cout, cin_logical, 3, 3) weights (1x1 embedded at the center).
    """
    cs_i, cs_o = ct.geom.c_slot, go.c_slot
    gp2 = go.gp2
    cout = w4.shape[0]
    p_out, p_in = go.p, ct.geom.p

    def add(key, base, li, lo, w_co_c):
        m = acc.setdefault((key, base), np.zeros((128, 128), np.int64))
        m[li:li + ct.n_ch, lo:lo + cout] += w_co_c.T

    kset = range(3) if kernel == 3 else (1,)
    if stride == 1 and p_in == p_out:
        for dy in kset:
            for dx in kset:
                for q_out in range(p_out):
                    q = q_out + dx - 1
                    goff = -1 if q < 0 else (1 if q >= p_in else 0)
                    q -= goff * p_in
                    add(ct.key, FRONT_PAD + dy * gp2 + goff,
                        q * cs_i + ct.src_c0, q_out * cs_o + out_c0,
                        w4[:, ct.dst_c0:ct.dst_c0 + ct.n_ch, dy, dx])
    elif stride == 2 and p_in == 2 * p_out and kernel == 3:
        for dy in range(3):
            key = ("s2o:" if dy == 1 else "s2e:") + ct.key
            roff = gp2 if dy == 2 else 0
            for dx in range(3):
                for q_out in range(p_out):
                    q = 2 * q_out + dx - 1
                    goff = -1 if q < 0 else (1 if q >= p_in else 0)
                    q -= goff * p_in
                    add(key, FRONT_PAD + roff + goff,
                        q * cs_i + ct.src_c0, q_out * cs_o + out_c0,
                        w4[:, ct.dst_c0:ct.dst_c0 + ct.n_ch, dy, dx])
    elif stride == 1 and kernel == 1 and 2 * p_in == p_out:
        # coarser-packed contribution into a denser 1x1 conv: even/odd
        # GROUP views in the output geometry (make_down2_plan generalized)
        for q_out in range(p_out):
            half, slot = divmod(q_out, p_in)
            key = ("eoo:" if half else "eoe:") + ct.key
            add(key, FRONT_PAD + gp2,
                slot * cs_i + ct.src_c0, q_out * cs_o + out_c0,
                w4[:, ct.dst_c0:ct.dst_c0 + ct.n_ch, 1, 1])
    else:
        raise _Bail(f"ratio p_in={p_in} p_out={p_out} stride={stride} "
                    f"kernel={kernel}")


def _finalize_taps(acc: Dict[Tuple[str, int], np.ndarray]
                   ) -> Tuple[List[Tuple[str, int, int]],
                              List[np.ndarray]]:
    """Split any accumulated matrix whose entries exceed int8 (colliding
    weight columns from overlapping contributions, e.g. a split half
    consumed directly AND through a residual chain) into extra taps."""
    taps, wlist = [], []
    for (key, base), m in acc.items():
        while True:
            part = np.clip(m, -127, 127)
            taps.append((key, len(wlist), base))
            wlist.append(part.astype(np.int8))
            m = m - part
            if not np.any(m):
                break
    return taps, wlist


def _lane_const(vals, geom: Geom, out_c0: int, cout: int,
                fill: int = 0) -> np.ndarray:
    lane = np.full((geom.p, geom.c_slot), fill, np.int64)
    lane[:, out_c0:out_c0 + cout] = np.asarray(vals, np.int64).reshape(
        1, -1)
    return lane.reshape(128)


class _Bail(Exception):
    """Planner: this conv (or node) cannot run slab-resident."""


# ---------------------------------------------------------------------------
# planner
# ---------------------------------------------------------------------------


def _pad_slot(c: int) -> int:
    for cand in (2, 4, 8, 16, 32, 64, 128):
        if cand >= c:
            return cand
    raise _Bail(f"channels {c} > 128")


def build_slab_plan(model, allow=None) -> SlabPlan:
    """Static walk over the graph: decide per-node slab/XLA mode, build
    tap matrices and the exec IR.  Deterministic, numpy-only.

    allow: optional predicate (node, c_in, h, w) -> bool restricting
    which convs may run as slab kernels (hybrid engines: keep only the
    regions where the banded kernel beats the XLA conv; everything else
    bails to the XLA path exactly like any other ineligible node)."""
    graph = model.graph
    size = model.cfg.image_size
    shape: Dict[str, Tuple[int, int, int]] = {
        graph.input_edge: (3, size, size)}
    sv: Dict[str, List[CPlan]] = {}
    env_avail = {graph.input_edge}
    pre_ops: Dict[int, list] = {}
    node_ops: Dict[int, list] = {}
    slab_nodes = set()
    lanes: Dict[str, dict] = {}
    kmeta: Dict[str, Geom] = {}     # slab key -> geometry
    n_convs = 0

    def amax_parts(edge, bound=None):
        a = int(model.edge_amax_int.get(edge, 127))
        if bound is not None:
            a = min(a, bound)
        return max(1, -(-a // 127))

    def entry_pack(idx, edge, p_target) -> List[CPlan]:
        """Pack an env edge into slabs at pixel density p_target (one
        slab per int8 part and per 128-channel block for wide tensors)."""
        c, h, w = shape[edge]
        if w % p_target:
            raise _Bail(f"W={w} %% p={p_target}")
        cs = 128 // p_target
        if c <= cs:
            blocks = [(0, c)]
        elif p_target == 1:
            blocks = [(b0, min(128, c - b0)) for b0 in range(0, c, 128)]
        else:
            raise _Bail(f"c={c} > slot {cs}")
        n_parts = amax_parts(edge)
        geom = Geom(cs, p_target, w // p_target, h)
        contribs = []
        for b0, n_ch in blocks:
            keys = [f"pk:{edge}:{b0}:{i}" for i in range(n_parts)]
            pre_ops.setdefault(idx, []).append(
                PackOp(keys, edge, geom, b0, n_ch, n_parts))
            for k in keys:
                kmeta[k] = geom
                contribs.append(CPlan(k, geom, 0, n_ch, b0))
        return contribs

    def resolve(idx, edge, p_target) -> List[CPlan]:
        if edge in sv:
            return sv[edge]
        if edge in env_avail:
            return entry_pack(idx, edge, p_target)
        raise _Bail(f"edge {edge} unavailable")

    def unpack_to_env(idx, edge):
        if edge in env_avail or edge not in sv:
            return
        c, h, w = shape[edge]
        wide = int(model.edge_amax_int.get(edge, 127)) > 127
        pre_ops.setdefault(idx, []).append(
            UnpackOp(edge, sv[edge], c, h, w, wide))
        env_avail.add(edge)

    def node_srcs(node):
        if isinstance(node, ConcatNode):
            return list(node.srcs)
        if isinstance(node, ResidualAddNode):
            return [node.src, node.base]
        if hasattr(node, "src"):
            return [node.src]
        return []

    for idx, node in enumerate(graph.nodes):
        n_pre0 = len(pre_ops.get(idx, []))
        try:
            if isinstance(node, ConvNode):
                c_in, h, w = shape[node.src]
                h_out, w_out = h // node.stride, w // node.stride
                shape[node.dst] = (node.cout, h_out, w_out)
                qc = model.convs[node.name]
                if not node.silu:
                    raise _Bail("plain conv (head 1x1) stays XLA")
                if node.kernel not in (1, 3) or node.stride not in (1, 2):
                    raise _Bail("kernel/stride")
                if node.padding != (1 if node.kernel == 3 else 0):
                    raise _Bail("padding")
                if allow is not None and not allow(node, c_in, h, w):
                    raise _Bail("filtered")
                if node.src in sv:
                    contribs = sv[node.src]
                else:
                    # entry heuristic: only pack from NCHW where the
                    # banded kernel can win (3x3 work at >=32x32; the
                    # @20 tails stay XLA — their kernels are trivial and
                    # the pack transposes are not)
                    if node.src not in env_avail or h * w < 1024 \
                            or c_in > 128 or node.kernel != 3:
                        raise _Bail("entry not profitable")
                    contribs = None  # resolved below once p_out known
                # output geometry from the max contribution density
                if contribs is not None:
                    p_max = max(ct.geom.p for ct in contribs)
                else:
                    p_max = 128 // _pad_slot(c_in)
                if node.stride == 2:
                    if p_max < 2 or h % 2:
                        raise _Bail("s2 needs p_in>=2, even H")
                    p_out = p_max // 2
                else:
                    p_out = p_max
                cs_o = 128 // p_out
                if node.cout > cs_o:
                    raise _Bail(f"cout {node.cout} > slot {cs_o}")
                if w_out % p_out:
                    raise _Bail("width")
                if contribs is None:
                    contribs = entry_pack(idx, node.src, p_max)
                go = Geom(cs_o, p_out, w_out // p_out, h_out)
                # contribution-density compatibility
                for ct in contribs:
                    ok = (ct.geom.p == p_max
                          or (node.stride == 1 and node.kernel == 1
                              and 2 * ct.geom.p == p_out))
                    if not ok:
                        raise _Bail("mixed densities")
                # out placement: align with the (single) source range so
                # later residual materializations stay lane-aligned
                out_c0 = 0
                if (len({(ct.src_c0, ct.geom.c_slot) for ct in contribs})
                        == 1 and contribs[0].geom.c_slot == cs_o
                        and contribs[0].src_c0 + node.cout <= cs_o):
                    out_c0 = contribs[0].src_c0
                w_q = np.int64(qc.w_q)
                if node.kernel == 1:
                    w4 = np.zeros(w_q.shape[:2] + (3, 3), np.int64)
                    w4[:, :, 1, 1] = w_q[:, :, 0, 0]
                else:
                    w4 = w_q
                acc: Dict[Tuple[str, int], np.ndarray] = {}
                for ct in contribs:
                    _emit_taps(acc, w4, ct, go, out_c0, node.stride,
                               node.kernel)
                taps, wlist = _finalize_taps(acc)
                key = f"cv:{node.name}"
                kmeta[key] = go
                lanes[node.name] = {
                    "bias": _lane_const(np.int64(qc.b_q).reshape(-1), go,
                                        out_c0, node.cout),
                    "r1": _lane_const(qc.r1, go, out_c0, node.cout),
                    "s1": _lane_const(qc.s1, go, out_c0, node.cout,
                                      fill=1),
                    "r2": _lane_const(qc.r2, go, out_c0, node.cout),
                    "s2": _lane_const(qc.s2, go, out_c0, node.cout,
                                      fill=1),
                }
                node_ops.setdefault(idx, []).append(
                    ConvOp(node.name, key, taps, wlist, go, out_c0,
                           h_out, node.silu))
                sv[node.dst] = [CPlan(key, go, out_c0, node.cout, 0)]
                slab_nodes.add(idx)
                n_convs += 1
            elif isinstance(node, SplitNode):
                c, h, w = shape[node.src]
                shape[node.dst1] = shape[node.dst2] = (c // 2, h, w)
                if node.src not in sv:
                    raise _Bail("split src not slab")
                half = c // 2
                for dst, lo, hi in ((node.dst1, 0, half),
                                    (node.dst2, half, c)):
                    out = []
                    for ct in sv[node.src]:
                        a = max(ct.dst_c0, lo)
                        b = min(ct.dst_c0 + ct.n_ch, hi)
                        if a < b:
                            out.append(CPlan(
                                ct.key, ct.geom,
                                ct.src_c0 + (a - ct.dst_c0), b - a,
                                a - lo))
                    sv[dst] = out
                slab_nodes.add(idx)
            elif isinstance(node, ResidualAddNode):
                shape[node.dst] = shape[node.src]
                if node.src not in sv or node.base not in sv:
                    raise _Bail("residual srcs not slab")
                (src_ct,) = sv[node.src]
                rq = (idx, node.src)
                if rq not in model.requants:
                    raise _Bail("missing residual requant")
                rkey = f"rq:{idx}"
                kmeta[rkey] = src_ct.geom
                node_ops.setdefault(idx, []).append(
                    EwReqOp(rkey, src_ct.key, rq))
                parts = [dataclasses.replace(src_ct, key=rkey)] \
                    + list(sv[node.base])
                bound = model.clip_after_residual.get(idx)
                if bound is not None:
                    align = {(ct.src_c0, ct.n_ch, ct.dst_c0, ct.geom)
                             for ct in parts}
                    if len(align) != 1:
                        raise _Bail("clip parts misaligned")
                    n_parts = amax_parts(node.dst, bound)
                    keys = [f"mt:{idx}:{i}" for i in range(n_parts)]
                    g0 = parts[0].geom
                    for k in keys:
                        kmeta[k] = g0
                    node_ops[idx].append(
                        MatOp(keys, [ct.key for ct in parts], bound,
                              None))
                    parts = [dataclasses.replace(parts[0], key=k)
                             for k in keys]
                sv[node.dst] = parts
                slab_nodes.add(idx)
            elif isinstance(node, ConcatNode):
                shapes_in = [shape[e] for e in node.srcs]
                c_tot = sum(s[0] for s in shapes_in)
                shape[node.dst] = (c_tot, shapes_in[0][1],
                                   shapes_in[0][2])
                if not any(e in sv for e in node.srcs):
                    raise _Bail("concat all-XLA")
                p_ref = max(ct.geom.p for e in node.srcs if e in sv
                            for ct in sv[e])
                out: List[CPlan] = []
                off = 0
                for e in node.srcs:
                    cts = resolve(idx, e, p_ref)
                    rq = (idx, e)
                    if rq in model.requants:
                        # disjoint dst ranges (channel blocks / concat
                        # pieces) requantize per-slab; ADDITIVE groups
                        # (lazy residual parts on one range) must be
                        # summed first — requant is nonlinear
                        groups: Dict[Tuple[int, int], list] = {}
                        for ct in cts:
                            groups.setdefault(
                                (ct.dst_c0, ct.n_ch), []).append(ct)
                        done: Dict[str, str] = {}
                        new_cts = []
                        for (d0, nc), g_cts in groups.items():
                            if len(g_cts) == 1:
                                ct = g_cts[0]
                                if ct.key not in done:
                                    rkey = (f"rq:{idx}:{e}:"
                                            f"{len(done)}")
                                    kmeta[rkey] = ct.geom
                                    node_ops.setdefault(idx, []).append(
                                        EwReqOp(rkey, ct.key, rq))
                                    done[ct.key] = rkey
                                new_cts.append(dataclasses.replace(
                                    ct, key=done[ct.key]))
                            else:
                                align = {(ct.src_c0, ct.n_ch, ct.geom)
                                         for ct in g_cts}
                                if len(align) != 1:
                                    raise _Bail("requant misaligned")
                                rkey = f"mt:{idx}:{e}:{d0}"
                                kmeta[rkey] = g_cts[0].geom
                                node_ops.setdefault(idx, []).append(
                                    MatOp([rkey],
                                          [ct.key for ct in g_cts],
                                          None, rq))
                                new_cts.append(dataclasses.replace(
                                    g_cts[0], key=rkey))
                        cts = new_cts
                    for ct in cts:
                        out.append(dataclasses.replace(
                            ct, dst_c0=ct.dst_c0 + off))
                    off += shape[e][0]
                sv[node.dst] = out
                slab_nodes.add(idx)
            elif isinstance(node, UpsampleNode):
                c, h, w = shape[node.src]
                shape[node.dst] = (c, h * node.factor, w * node.factor)
                if node.src not in sv or node.factor != 2:
                    raise _Bail("upsample src not slab")
                cts = sv[node.src]
                if any(ct.geom.p != 1 for ct in cts):
                    raise _Bail("upsample needs p==1")
                out = []
                for i, ct in enumerate(cts):
                    k = f"up:{idx}:{i}"
                    kmeta[k] = Geom(ct.geom.c_slot, 1, ct.geom.g * 2,
                                    ct.geom.h * 2)
                    node_ops.setdefault(idx, []).append(
                        UpsampleOp(k, ct.key, ct.geom))
                    out.append(dataclasses.replace(
                        ct, key=k, geom=kmeta[k]))
                sv[node.dst] = out
                slab_nodes.add(idx)
            elif isinstance(node, MaxPoolNode):
                shape[node.dst] = shape[node.src]
                raise _Bail("maxpool stays XLA")
            else:
                raise _Bail(f"node {type(node).__name__}")
        except _Bail:
            # drop any ops partially emitted for this idx (entry packs
            # resolved before the bail), then fall back to XLA: make
            # sure every input is in env
            node_ops.pop(idx, None)
            if idx in pre_ops:
                del pre_ops[idx][n_pre0:]
            slab_nodes.discard(idx)
            for e in node_srcs(node):
                unpack_to_env(idx, e)
            for e in _node_dsts(node):
                env_avail.add(e)

    # graph outputs that ended slab-only (none in the current region map,
    # but keep the invariant): unpack at the very end
    end = len(graph.nodes)
    for role, e in graph.outputs.items():
        if e in sv and e not in env_avail:
            c, h, w = shape[e]
            pre_ops.setdefault(end, []).append(
                UnpackOp(e, sv[e], c, h, w, True))
            env_avail.add(e)

    return SlabPlan(pre_ops=pre_ops, node_ops=node_ops, nodes=slab_nodes,
                    lanes=lanes, geoms=kmeta, n_convs=n_convs)


def _node_dsts(node):
    if isinstance(node, SplitNode):
        return [node.dst1, node.dst2]
    return [node.dst] if hasattr(node, "dst") else []


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------


class SlabExec:
    """Runs a SlabPlan's ops inside int_forward's node loop: resolves slab
    keys to tensors and reads/writes the NHWC env."""

    def __init__(self, sp: SlabPlan, model, plan: Dict,
                 env: Dict[str, torch.Tensor], qmax: int):
        self.sp = sp
        self.model = model
        self.plan = plan
        self.env = env
        self.qmax = qmax
        self.slabs: Dict[str, torch.Tensor] = {}
        # per-conv device tensors, kept in the plan for as long as it
        # holds this SlabPlan
        cached = plan.get("slab_dev")
        if cached is None or cached[0] is not sp:
            cached = plan["slab_dev"] = (sp, {})
        self.dev: Dict[str, Dict] = cached[1]

    # -- derived slab views (row/group slicing, no lane movement) --------

    def get(self, key: str) -> torch.Tensor:
        if key in self.slabs:
            return self.slabs[key]
        kind, base = key.split(":", 1)
        src, geom = self.get(base), self.sp.geoms[base]
        if kind in ("s2e", "s2o"):
            a, b = _s2_split(src, geom)
            self.slabs["s2e:" + base] = a
            self.slabs["s2o:" + base] = b
        elif kind in ("eoe", "eoo"):
            e, o = _eo_split(src, geom)
            self.slabs["eoe:" + base] = e
            self.slabs["eoo:" + base] = o
        else:
            raise KeyError(key)
        return self.slabs[key]

    # -- op execution ----------------------------------------------------

    def run(self, ops) -> None:
        for op in ops:
            getattr(self, "_" + type(op).__name__)(op)

    def _PackOp(self, op: PackOp) -> None:
        x = self.env[op.env_edge][..., op.c0:op.c0 + op.n_ch].to(torch.int32)
        rem = x
        for key in op.keys:
            part = torch.clamp(rem, -127, 127) if op.n_parts > 1 else rem
            if op.n_parts > 1:
                rem = rem - part
            self.slabs[key] = _pack_nhwc(part, op.geom)

    def conv_inputs(self, op: ConvOp):
        """(slabs, taps) of a ConvOp: its distinct input slabs and the
        taps as (slab index, matrix index, row base)."""
        keys: List[str] = []
        for k, _, _ in op.taps:
            if k not in keys:
                keys.append(k)
        return ([self.get(k) for k in keys],
                [(keys.index(k), w, b) for k, w, b in op.taps])

    def entry(self, op: ConvOp) -> Dict:
        """The conv's packed_entry on the plan's device, built once."""
        e = self.dev.get(op.name)
        if e is None:
            ln = self.sp.lanes[op.name]
            e = self.dev[op.name] = pc.packed_entry(
                op.wlist, ln["bias"], ln["r1"], ln["s1"], ln["r2"], ln["s2"],
                op.silu, self.plan["device"])
        return e

    def _ConvOp(self, op: ConvOp) -> None:
        x_slabs, taps = self.conv_inputs(op)
        self.slabs[op.key] = pc.packed_call(
            x_slabs, taps, self.entry(op), op.geom.gp2, op.h_out,
            self.plan["sig_lut"], self.qmax)

    def _EwReqOp(self, op: EwReqOp) -> None:
        r, s = self.plan["requants"][op.rq]
        self.slabs[op.key] = requantize_small(
            self.get(op.src_key), r, s, self.qmax).to(torch.int8)

    def _MatOp(self, op: MatOp) -> None:
        v = None
        for k in op.src_keys:
            t = self.get(k).to(torch.int32)
            v = t if v is None else v + t
        if op.clip_bound is not None:
            v = torch.clamp(v, -op.clip_bound, op.clip_bound)
        if op.rq is not None:
            r, s = self.plan["requants"][op.rq]
            self.slabs[op.keys[0]] = requantize_small(
                v, r, s, self.qmax).to(torch.int8)
            return
        for key in op.keys:
            part = torch.clamp(v, -127, 127)
            v = v - part
            self.slabs[key] = part.to(torch.int8)

    def _UpsampleOp(self, op: UpsampleOp) -> None:
        g, h = op.geom_in.g, op.geom_in.h
        src = self.get(op.src_key)
        b = src.shape[0]
        x = src[:, FRONT_PAD:FRONT_PAD + (h + 2) * (g + 2)]
        x = x.reshape(b, h + 2, g + 2, 128)[:, 1:-1, 1:-1]
        x = x[:, :, None, :, None].expand(b, h, 2, g, 2, 128)
        go = Geom(op.geom_in.c_slot, 1, 2 * g, 2 * h)
        self.slabs[op.key] = pc.ext_slab(x.reshape(b, 2 * h, 2 * g, 128),
                                         go.rows_ext, (1, 1), (1, 1))

    def _UnpackOp(self, op: UnpackOp) -> None:
        out = None
        for ct in op.contribs:
            s = self.get(ct.key)
            b = s.shape[0]
            g, h, p, cs = ct.geom.g, ct.geom.h, ct.geom.p, ct.geom.c_slot
            x = s[:, FRONT_PAD:FRONT_PAD + (h + 2) * (g + 2)]
            x = x.reshape(b, h + 2, g + 2, 128)[:, 1:-1, 1:-1]
            x = x.reshape(b, h, g, p, cs)[..., ct.src_c0:ct.src_c0 + ct.n_ch]
            x = x.reshape(b, h, g * p, ct.n_ch).to(torch.int32)
            if out is None and len(op.contribs) == 1 \
                    and ct.dst_c0 == 0 and ct.n_ch == op.c:
                out = x
                break
            if out is None:
                out = torch.zeros((b, op.h, op.w, op.c), dtype=torch.int32,
                                  device=x.device)
            out[..., ct.dst_c0:ct.dst_c0 + ct.n_ch] += x
        dt = torch.int16 if op.wide else torch.int8
        self.env[op.env_edge] = out.to(dt).contiguous()


# ---------------------------------------------------------------------------
# layout helpers (row/group slicing)
# ---------------------------------------------------------------------------


def _pack_nhwc(x_nhwc: torch.Tensor, geom: Geom) -> torch.Tensor:
    """NHWC part (|v| <= 127) -> extended slab in ``geom``."""
    b, h, w, c = x_nhwc.shape
    x = x_nhwc.to(torch.int8)
    if geom.c_slot != c:
        x = torch.nn.functional.pad(x, (0, geom.c_slot - c))
    return pc.ext_slab(x.reshape(b, h, geom.g, 128), geom.rows_ext, (1, 1),
                       (1, 1))


def _s2_split(slab: torch.Tensor, geom: Geom):
    """Extended slab -> even/odd padded-row block slabs (the stride-2
    kernel's A/B operands; packed_conv.pack_tensor_s2's geometry)."""
    b = slab.shape[0]
    g, h = geom.g, geom.h
    gp2 = g + 2
    x = slab[:, FRONT_PAD:FRONT_PAD + (h + 2) * gp2]
    x = x.reshape(b, h + 2, gp2, 128)
    r_ext = pc.rows_ext(h // 2 + 1, gp2)
    return pc.ext_slab(x[:, 0::2], r_ext), pc.ext_slab(x[:, 1::2], r_ext)


def _eo_split(slab: torch.Tensor, geom: Geom):
    """Extended slab -> even/odd GROUP slabs in the half-group geometry
    (coarser contribution feeding a denser 1x1 conv)."""
    b = slab.shape[0]
    g, h = geom.g, geom.h
    x = slab[:, FRONT_PAD:FRONT_PAD + (h + 2) * (g + 2)]
    x = x.reshape(b, h + 2, g + 2, 128)[:, :, 1:-1]
    go = Geom(geom.c_slot, geom.p, g // 2, h)
    return (pc.ext_slab(x[:, :, 0::2], go.rows_ext, (0, 0), (1, 1)),
            pc.ext_slab(x[:, :, 1::2], go.rows_ext, (0, 0), (1, 1)))
