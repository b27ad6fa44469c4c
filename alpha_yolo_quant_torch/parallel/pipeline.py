"""GPipe-style pipeline parallelism (pp) over a mesh axis (counterpart of
alpha_yolo_quant_tpu/parallel/pipeline.py).

The ordered graph IR is split into S contiguous stages balanced by conv
MACs (models.graph.node_costs); the rank at index s of the 'pp' axis runs
stage s, and microbatches flow from rank to rank in the GPipe
fill/steady/drain schedule: T = M + S - 1 ticks for M microbatches, stage
s running microbatch t - s at tick t. Between ticks each rank sends its
result to the next stage and receives the next input from the previous
one, in one batch of point-to-point ops.

Exactness: stage boundaries move activations as one flat int32 buffer.
Every inter-stage edge holds integers (int8 edges, wide int16 edges, int32
head accumulators), so the cast -> send -> cast round trip is exact, and
each stage runs the unchanged int_forward node loop over its node range
(the segment seam of runtime/interpreter.py): the pipelined result equals
the unsharded engine's bit for bit by construction.

The JAX module runs its pipeline on the ``auto`` engine with bf16 and
int32 edges; the port's stages run the fused engine with int8/int16 edges.
The boundaries, the edges that cross them, their shapes and the buffer
width are the same; the dtypes differ.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from alpha_yolo_quant_torch.models.graph import (
    ConcatNode, ConvNode, Graph, MaxPoolNode, ResidualAddNode, SplitNode,
    UpsampleNode, edge_shapes, node_costs,
)


def _node_io(node) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    if isinstance(node, ConvNode):
        return (node.src,), (node.dst,)
    if isinstance(node, SplitNode):
        return (node.src,), (node.dst1, node.dst2)
    if isinstance(node, ResidualAddNode):
        return (node.src, node.base), (node.dst,)
    if isinstance(node, ConcatNode):
        return tuple(node.srcs), (node.dst,)
    if isinstance(node, (MaxPoolNode, UpsampleNode)):
        return (node.src,), (node.dst,)
    raise TypeError(type(node))


def _choose_cuts(graph: Graph, image_size: int, n_stages: int):
    """Contiguous stage boundaries (node indices) balancing conv MACs."""
    costs = node_costs(graph, image_size)
    n = len(costs)
    if not 1 <= n_stages <= n:
        raise ValueError(f"n_stages={n_stages} for a {n}-node graph")
    pref = np.cumsum([0] + costs)
    bounds = [0]
    for s in range(1, n_stages):
        c = int(np.searchsorted(pref, pref[-1] * s / n_stages))
        c = max(c, bounds[-1] + 1)          # non-empty stages
        c = min(c, n - (n_stages - s))
        bounds.append(c)
    bounds.append(n)
    return bounds


def _live_edges(graph: Graph, cut: int) -> Tuple[str, ...]:
    """Edges produced before node index `cut` and still consumed at or
    after it (graph outputs stay live to the end). Deterministic order:
    by producer index, then name."""
    produced = {graph.input_edge: -1}
    last_use: Dict[str, int] = {}
    for i, node in enumerate(graph.nodes):
        ins, outs = _node_io(node)
        for e in ins:
            last_use[e] = i
        for e in outs:
            produced[e] = i
    for e in graph.outputs.values():
        last_use[e] = len(graph.nodes)
    live = [e for e, pi in produced.items()
            if pi < cut and last_use.get(e, -1) >= cut]
    live.sort(key=lambda e: (produced[e], e))
    return tuple(live)


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """Static pipeline plan: stage node ranges, per-stage live boundary
    edges, per-microbatch edge specs (NCHW shape, dtype), and the (shared)
    int32 transport buffer width."""

    boundaries: Tuple[int, ...]                       # len S+1
    stage_in_edges: Tuple[Tuple[str, ...], ...]
    stage_out_edges: Tuple[Tuple[str, ...], ...]
    edge_specs: Dict[str, Tuple[Tuple[int, ...], torch.dtype]]
    buf_width: int
    microbatch: int
    n_microbatches: int

    @property
    def n_stages(self) -> int:
        return len(self.stage_in_edges)


def _pack(tensors, width: int) -> torch.Tensor:
    buf = torch.cat([t.to(torch.int32).reshape(-1) for t in tensors])
    pad = width - buf.shape[0]
    if pad:
        buf = torch.cat([buf, buf.new_zeros((pad,))])
    return buf


def _unpack(buf: torch.Tensor, edges, edge_specs) -> Dict[str, torch.Tensor]:
    env, off = {}, 0
    for e in edges:
        shape, dt = edge_specs[e]
        n = int(np.prod(shape))
        env[e] = buf[off:off + n].reshape(shape).to(dt)
        off += n
    return env


def _edge_dtypes(model) -> Dict[str, torch.dtype]:
    """The dtype int_forward stores on each edge: int8 input, int8 SiLU
    conv outputs and int32 raw head accumulators; splits, pools and
    upsamples keep their source's; residuals and concats are int16 where
    the edge is wide (interpreter._store_dtype)."""
    from alpha_yolo_quant_torch.runtime.interpreter import _store_dtype

    graph = model.graph
    dts = {graph.input_edge: torch.int8}
    for node in graph.nodes:
        if isinstance(node, ConvNode):
            dts[node.dst] = torch.int8 if node.silu else torch.int32
        elif isinstance(node, SplitNode):
            dts[node.dst1] = dts[node.dst2] = dts[node.src]
        elif isinstance(node, (ResidualAddNode, ConcatNode)):
            dts[node.dst] = _store_dtype(model, node.dst)
        else:
            dts[node.dst] = dts[node.src]
    return dts


def build_pipeline_spec(model, n_stages: int, microbatch: int,
                        n_microbatches: int) -> PipelineSpec:
    """Plan an S-stage pipeline: balanced cuts, live-edge boundary sets,
    and the boundary tensors' shapes (a shape walk of the IR) and dtypes.
    No forward runs, so JAX's device-plan argument has no counterpart.
    The stages run the fused engine."""
    graph = model.graph
    bounds = _choose_cuts(graph, model.cfg.image_size, n_stages)
    roles = sorted(graph.outputs)
    out_last = tuple(dict.fromkeys(graph.outputs[r] for r in roles))
    ins, outs = [], []
    for s in range(n_stages):
        ins.append(_live_edges(graph, bounds[s]))
        outs.append(_live_edges(graph, bounds[s + 1])
                    if s < n_stages - 1 else out_last)
    shapes = edge_shapes(graph, model.cfg.image_size)
    dts = _edge_dtypes(model)
    specs = {e: ((microbatch,) + shapes[e], dts[e])
             for s in range(n_stages) for e in ins[s] + outs[s]}
    widths = [sum(int(np.prod(specs[e][0])) for e in edges)
              for edges in ins + outs]
    return PipelineSpec(
        boundaries=tuple(bounds), stage_in_edges=tuple(ins),
        stage_out_edges=tuple(outs), edge_specs=specs,
        buf_width=max(widths), microbatch=microbatch,
        n_microbatches=n_microbatches)


def pipeline_forward(model, plan, spec: PipelineSpec, mesh,
                     axis: str = "pp", dp_axis: str = None):
    """fn(images) -> the six raw int32 head accumulators (NCHW), the dict
    int_forward returns, with the forward pipelined over ``axis``.

    images: (microbatch * n_microbatches, 3, H, W), float or uint8, the
    same batch on every rank of the axis (only the first stage reads it).
    The last stage's results are broadcast over the axis, so every rank
    returns them (JAX's masked psum). Decode and NMS run after, on every
    rank. Bitwise equal to the unsharded engine.

    dp_axis: compose with data parallelism on a 2-D (dp, pp) mesh. The
    input is then dp * microbatch * n_microbatches images; each dp group
    runs its own pipeline over its rows and returns them (batch-sharded
    over dp_axis: parallel.mesh.gather_batch assembles them)."""
    from alpha_yolo_quant_torch.parallel.mesh import (
        _peer, _to_wire, _wire_device, axis_coord, shard_batch, warm_up,
    )
    from alpha_yolo_quant_torch.runtime.interpreter import (
        int_forward, quantize_input,
    )

    graph = model.graph
    S = spec.n_stages
    s, n_pp = axis_coord(mesh, axis)
    if n_pp != S:
        raise ValueError(f"mesh axis '{axis}' has {n_pp} devices but the "
                         f"spec has {S} stages")
    group = mesh.get_group(axis)
    n_dp = axis_coord(mesh, dp_axis)[1] if dp_axis else 1
    M, mb, W = spec.n_microbatches, spec.microbatch, spec.buf_width
    bounds = spec.boundaries
    roles = sorted(graph.outputs)
    last_edges = spec.stage_out_edges[-1]
    device = plan["device"]
    wire = _wire_device(group)
    warm_up(group)

    def run_stage(env):
        res = int_forward(model, plan, None, env_in=env,
                          node_range=(bounds[s], bounds[s + 1]),
                          out_edges=spec.stage_out_edges[s])
        return _pack([res[e] for e in spec.stage_out_edges[s]], W)

    @torch.no_grad()
    def fn(images):
        want = mb * M * n_dp
        if images.shape[0] != want:
            raise ValueError(
                f"pipeline batch must be microbatch*n_microbatches"
                f"{'*dp' if dp_axis else ''} = {want}, "
                f"got {images.shape[0]}")
        if dp_axis:
            images = shard_batch(mesh, images, dp_axis)
        if s == 0:
            x_q = quantize_input(torch.as_tensor(images, device=device),
                                 model.cfg.k)
        slots = torch.zeros((M, W), dtype=torch.int32, device=wire)
        recv = None
        for t in range(M + S - 1):
            m = t - s
            out = None
            if 0 <= m < M:
                env = ({graph.input_edge: x_q[m * mb:(m + 1) * mb]}
                       if s == 0 else
                       _unpack(recv.to(device), spec.stage_in_edges[s],
                               spec.edge_specs))
                out = _to_wire(run_stage(env), group)
                if s == S - 1:
                    slots[m] = out
            ops = []
            if out is not None and s < S - 1:
                ops.append(dist.P2POp(dist.isend, out, _peer(group, s + 1),
                                      group))
            if s > 0 and 0 <= t + 1 - s < M:
                recv = torch.empty((W,), dtype=torch.int32, device=wire)
                ops.append(dist.P2POp(dist.irecv, recv, _peer(group, s - 1),
                                      group))
            if ops:
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
        dist.broadcast(slots, src=_peer(group, S - 1), group=group)
        per_mb = [_unpack(slots[m].to(device), last_edges, spec.edge_specs)
                  for m in range(M)]
        env = {e: torch.cat([p[e] for p in per_mb], 0) for e in last_edges}
        return {r: env[graph.outputs[r]] for r in roles}

    return fn


def build_pp_pipeline(model, mesh, n_stages: int, microbatch: int,
                      n_microbatches: int, dfl_w_float=None, device="cuda"):
    """images -> detections with the forward pipelined over the mesh's
    'pp' axis: the pp analog of runtime.interpreter.build_int_pipeline.
    Quantize, then the pipelined forward, then decode_full_quant on the raw
    accumulators (or the float head of a partial-quant model, which needs
    dfl_w_float), then NMS with the model's default parameters, on every
    rank of the axis. Returns (fn, spec)."""
    from alpha_yolo_quant_torch.postprocess.nms import (
        NmsParams, non_max_suppression, q_nms_params,
    )
    from alpha_yolo_quant_torch.runtime.interpreter import (
        decode_float, decode_full_quant, dequantize_heads, device_plan,
    )

    device = torch.device(device)
    plan = device_plan(model, device)
    spec = build_pipeline_spec(model, n_stages, microbatch, n_microbatches)
    fwd = pipeline_forward(model, plan, spec, mesh)
    full = model.cfg.full_quant
    nms_params = (q_nms_params(model.head.anchor_scale) if full
                  else NmsParams(conf_thres=0.25))
    if not full:
        if dfl_w_float is None:
            raise ValueError("partial-quant pipeline needs dfl_w_float")
        dfl_w = torch.as_tensor(np.asarray(dfl_w_float), dtype=torch.float32,
                                device=device)

    @torch.no_grad()
    def fn(images):
        outs = fwd(images)
        preds = (decode_full_quant(model, plan, outs) if full
                 else decode_float(dequantize_heads(model, outs), dfl_w))
        return non_max_suppression(preds, nms_params)

    return fn, spec
