"""Process groups, meshes and sharded steps on torch.distributed
(counterpart of alpha_yolo_quant_tpu/parallel/mesh.py).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims;
``mesh.get_group(axis)`` is the process group of one axis. Where JAX
shards a global array and lets XLA insert the collectives, every rank here
holds the global input (or its own rows of it), runs its share of the work
and moves data itself:

- dp: each rank runs the pipeline on its contiguous block of rows
  (``data_parallel_step``); outputs stay on their rank until
  ``gather_batch`` assembles them in global row order;
- tp: each rank computes its slice of every conv's output channels and
  all-gathers the rest before the next layer (``tensor_parallel_fn``);
- sp: each rank holds a band of rows of every edge and swaps halo rows
  with the ranks around it before each node that reads them
  (``spatial_parallel_fn``); the head edges are all-gathered at the end.

Backends: ``nccl`` runs one rank per card; ``gloo`` runs CPU ranks, or
ranks that share one card (NCCL refuses two ranks on one card). Gloo moves
host memory only, so tensors cross a gloo group through host copies; and
neither backend carries int16, so the wide int16 edges travel as int32.
Both conversions are exact.

Every process group gets a 60 s timeout on its rendezvous and on each
collective, so a rank that dies makes the others fail, not hang.
"""

from __future__ import annotations

import datetime
import os
import socket
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from alpha_yolo_quant_torch.serving import _tree_map

TIMEOUT_S = 60
BACKENDS = ("nccl", "gloo")


def init_distributed(backend: str, init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join this process to the default process group (counterpart of
    initialize_multihost). Arguments left None come from a launcher's
    environment (torchrun: RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
    MASTER_PORT). The backend is always the caller's choice: ``nccl``
    binds the rank to ``cuda:<local rank>`` and returns that device;
    ``gloo`` returns the CPU (a caller that shares a card between gloo
    ranks places its tensors there itself)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    env = os.environ
    world_size = int(env["WORLD_SIZE"]) if world_size is None else world_size
    rank = int(env["RANK"]) if rank is None else rank
    local_rank = int(env.get("LOCAL_RANK", rank))
    device = torch.device("cpu")
    if backend == "nccl":
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_rank >= n:
            raise RuntimeError(f"nccl rank {rank} needs cuda:{local_rank} "
                               f"but only {n} cards are visible")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return device


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, backend, target, args, queue):
    # one intra-op thread per rank: ranks share the host's cores
    torch.set_num_threads(1)
    init_distributed(backend, f"tcp://127.0.0.1:{port}", world, rank)
    try:
        out = target(rank, *args)
        if rank == 0:
            queue.put(out)
    finally:
        dist.destroy_process_group()


def run_ranks(target, args: tuple, world: int, backend: str,
              deadline_s: float = 1800.0):
    """Spawn ``world`` ranks on this host, joined through a localhost TCP
    store: rank r runs init_distributed(backend, rank=r), then
    ``target(r, *args)``. Returns rank 0's return value (it must pickle).
    A rank that raises fails the run: its traceback is raised here and the
    other ranks are stopped. If ``deadline_s`` passes first, every rank is
    killed and TimeoutError raised. ``target`` is pickled by reference, so
    it is a module-level function."""
    import torch.multiprocessing as mp

    sys.stdout.flush()
    sys.stderr.flush()
    queue = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(
        _rank_main, args=(world, free_port(), backend, target, args,
                          queue),
        nprocs=world, join=False, start_method="spawn")
    t_end = time.monotonic() + deadline_s
    got, result = False, None
    try:
        while True:
            # read rank 0's result while the ranks run: a result larger
            # than the pipe's buffer blocks its writer until it is read
            if not got and not queue.empty():
                got, result = True, queue.get()
            if ctx.join(timeout=0.2):
                break
            if time.monotonic() > t_end:
                raise TimeoutError(f"{world} ranks of {target.__name__} "
                                   f"ran past their {deadline_s:.0f} s "
                                   "deadline")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    if not got:
        if queue.empty():
            raise RuntimeError("rank 0 ended without a result")
        result = queue.get()
    return result


def _mesh_device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp"
              ) -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` ranks (all by default). Every
    rank of the world calls it; a rank outside the mesh gets a mesh whose
    ``get_coordinate()`` is None."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested a {n}-device mesh but only {world} "
                         "devices are visible")
    return init_device_mesh(_mesh_device_type(), (n,),
                            mesh_dim_names=(axis,))


def make_mesh_2d(dp: int, tp: int, axes=("dp", "tp")) -> DeviceMesh:
    """(dp, tp) mesh over the first dp * tp ranks: batch over the first
    axis, the second for tp, sp or pp (``axes`` names them)."""
    world = dist.get_world_size()
    if dp * tp > world:
        raise ValueError(f"requested a {dp * tp}-device mesh but only "
                         f"{world} devices are visible")
    return init_device_mesh(_mesh_device_type(), (dp, tp),
                            mesh_dim_names=tuple(axes))


def in_mesh(mesh: DeviceMesh) -> bool:
    return mesh.get_coordinate() is not None


def axis_coord(mesh: DeviceMesh, axis: str):
    """(this rank's index along ``axis``, the axis's size)."""
    dim = mesh.mesh_dim_names.index(axis)
    return mesh.get_coordinate()[dim], mesh.shape[dim]


def _peer(group, i: int) -> int:
    """Global rank of the group's i-th member."""
    return dist.get_global_rank(group, i)


def _wire_device(group) -> torch.device:
    if dist.get_backend(group) == "gloo":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def _wire_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.int32 if dt == torch.int16 else dt


def _to_wire(t: torch.Tensor, group) -> torch.Tensor:
    """t as the group's backend carries it: on the host for gloo, int16 as
    int32 (exact)."""
    return t.to(device=_wire_device(group),
                dtype=_wire_dtype(t.dtype)).contiguous()


def warm_up(group) -> None:
    """One collective on the group. NCCL lets a batch of point-to-point
    ops involve only some of a group's ranks once the group has run a
    collective; the pp and sp paths call this before their first one."""
    t = torch.zeros((1,), device=_wire_device(group))
    dist.all_reduce(t, group=group)


def _all_gather_cat(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every group member's ``t`` along ``dim``, in group
    order (equal shapes on every member)."""
    w = _to_wire(t, group)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, w, group=group)
    return torch.cat(parts, dim).to(device=t.device, dtype=t.dtype)


def shard_batch(mesh: DeviceMesh, x, axis: str = "dp"):
    """This rank's contiguous block of rows of a global batch (numpy or
    torch), as JAX's P(axis) places them. The batch must divide over the
    axis."""
    i, n = axis_coord(mesh, axis)
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not divide over the {n} ranks of "
                         f"mesh axis '{axis}'")
    k = b // n
    return x[i * k:(i + 1) * k]


def replicate(mesh: DeviceMesh, tree):
    """Every leaf (tensor or numpy array) as the mesh's first rank holds
    it: broadcast along each mesh dim from its index 0."""
    def bcast(leaf):
        t = torch.as_tensor(leaf).clone()   # the caller's leaf stays as is
        for axis in mesh.mesh_dim_names:
            group = mesh.get_group(axis)
            w = _to_wire(t, group)
            dist.broadcast(w, src=_peer(group, 0), group=group)
            t = w.to(device=t.device, dtype=t.dtype)
        return t.numpy() if isinstance(leaf, np.ndarray) else t

    return _tree_map(bcast, tree)


def shard_params_tp(mesh: DeviceMesh, params, axis: str = "tp"):
    """This rank's C_out slice of every conv's weights (O, I, kh, kw) and
    bias (O,); the DFL weights stay whole."""
    i, n = axis_coord(mesh, axis)
    out = {}
    for key, p in params.items():
        if key == "dfl":
            out[key] = p
            continue
        o = p["w"].shape[0]
        if o % n:
            raise ValueError(f"{key}: {o} output channels do not divide "
                             f"over {n} tp ranks")
        k = o // n
        out[key] = {"w": p["w"][i * k:(i + 1) * k],
                    "b": p["b"][i * k:(i + 1) * k]}
    return out


def data_parallel_step(fn, mesh: DeviceMesh, axis: str = "dp"):
    """step(global batch) runs fn on this rank's rows (shard_batch) and
    returns its outputs for those rows only: they stay batch-sharded, as
    JAX's out_specs=P(axis) leaves them. gather_batch assembles them."""
    def step(x):
        return fn(shard_batch(mesh, x, axis))

    return step


def gather_batch(mesh: DeviceMesh, tree, axis: str = "dp"):
    """Every tensor leaf of a batch-sharded output, concatenated over the
    axis's ranks in global row order (on each rank)."""
    group = mesh.get_group(axis)
    return _tree_map(lambda t: _all_gather_cat(t, group, 0), tree)


_DTYPES = (torch.float32, torch.uint8, torch.int8, torch.int32, torch.int64,
           torch.float64, torch.int16)
_HEADER = 8       # ndim, dtype code, up to six dims


class BatchFeed:
    """The controller's batches, shared with every rank of an axis: the
    axis's first rank sends each batch as a header (ndim, dtype, shape)
    and then the tensor; a header with ndim -1 stops the others.

    On the controller: ``send(x)`` (returns x as a tensor on ``device``)
    and ``stop()``. On the others: iterate the feed; each item is the next
    batch on ``device``."""

    def __init__(self, mesh: DeviceMesh, device, axis: str = "dp"):
        self.group = mesh.get_group(axis)
        self.src = _peer(self.group, 0)
        self.device = torch.device(device)
        self.wire = _wire_device(self.group)

    @property
    def controller(self) -> bool:
        return dist.get_rank() == self.src

    def _header(self, values=None) -> torch.Tensor:
        h = torch.full((_HEADER,), -1, dtype=torch.int64, device=self.wire)
        if values is not None:
            h[:len(values)] = torch.as_tensor(values, dtype=torch.int64)
        dist.broadcast(h, src=self.src, group=self.group)
        return h

    def send(self, x) -> torch.Tensor:
        t = torch.as_tensor(x)
        if t.dim() > _HEADER - 2:
            raise ValueError(f"a batch of {t.dim()} dims")
        self._header([t.dim(), _DTYPES.index(t.dtype), *t.shape])
        dist.broadcast(_to_wire(t, self.group), src=self.src,
                       group=self.group)
        return t.to(self.device)

    def stop(self) -> None:
        self._header()

    def __iter__(self):
        while True:
            h = self._header().tolist()
            if h[0] < 0:
                return
            dt = _DTYPES[h[1]]
            w = torch.empty(h[2:2 + h[0]], device=self.wire,
                            dtype=_wire_dtype(dt))
            dist.broadcast(w, src=self.src, group=self.group)
            yield w.to(device=self.device, dtype=dt)

    def share(self, batches):
        """Every rank iterates the controller's ``batches`` (ignored on the
        others) in lockstep."""
        if not self.controller:
            yield from self
            return
        try:
            for x in batches:
                yield self.send(x)
        finally:
            self.stop()


def sharded_forward_fn(graph, mesh: DeviceMesh, decode: bool = True,
                       collect_taps: bool = False, axis: str = "dp"):
    """step(params, images): the float forward (+ decode) on this rank's
    rows of the global batch; params (torch, models.params.params_to_torch)
    on every rank. Returns {"preds" or "outputs": this rank's rows} and,
    with collect_taps, {"taps": {tap: global max}}: the per-tap maxima
    all-reduced with MAX over the axis."""
    from alpha_yolo_quant_torch.models.forward import forward_float
    from alpha_yolo_quant_torch.models.head import decode_float

    group = mesh.get_group(axis)

    @torch.no_grad()
    def step(params, images):
        dev = params["dfl"]["w"].device
        x = torch.as_tensor(shard_batch(mesh, images, axis),
                            dtype=torch.float32, device=dev)
        outs, taps = forward_float(graph, params, x,
                                   collect_taps=collect_taps)
        res: Dict = {}
        if decode:
            res["preds"] = decode_float(outs, params["dfl"]["w"])
        else:
            res["outputs"] = outs
        if collect_taps:
            names = sorted(taps)
            m = _to_wire(torch.stack([torch.amax(taps[k]) for k in names]),
                         group)
            dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
            res["taps"] = {k: m[j].to(dev) for j, k in enumerate(names)}
        return res

    return step


def tensor_parallel_fn(graph, mesh: DeviceMesh, axis: str = "tp",
                       dp_axis: Optional[str] = None):
    """step(params_tp, images) -> float preds (decode_float): every conv
    runs on this rank's C_out slice (shard_params_tp) and all-gathers the
    other slices over ``axis`` before the next node, where JAX lets XLA
    insert the gathers. With ``dp_axis`` the rows shard over it (a (dp,
    tp) mesh) and the preds stay batch-sharded."""
    from alpha_yolo_quant_torch.models.forward import forward_float
    from alpha_yolo_quant_torch.models.graph import require_dense_graph
    from alpha_yolo_quant_torch.models.head import decode_float
    from alpha_yolo_quant_torch.ops.nn import conv2d_f32

    # a depthwise conv's channels do not split as a dense conv's C_out
    require_dense_graph(graph, "tensor parallel")
    group = mesh.get_group(axis)

    def conv(x, w, b, stride, padding):
        return _all_gather_cat(conv2d_f32(x, w, b, stride, padding), group,
                               1)

    @torch.no_grad()
    def step(params_tp, images):
        dev = params_tp["dfl"]["w"].device
        x = shard_batch(mesh, images, dp_axis) if dp_axis else images
        x = torch.as_tensor(x, dtype=torch.float32, device=dev)
        outs, _ = forward_float(graph, params_tp, x, conv=conv)
        return decode_float(outs, params_tp["dfl"]["w"])

    return step


# ---- sp: height bands with halo exchange ---------------------------------


def _halo(node):
    """(rows above, rows below, stride) a node reads beyond its output
    band, or None for a node that reads its own rows only.

    3x3 s1: one row each side. 3x3 s2: two rows above and none below: a
    band starts on an even row, and two rows keep that parity under the
    kernel's fixed pad 1 (the first output row, computed over the pad, is
    dropped). SPPF max-pool (k5 p2): two rows each side. 1x1 convs, split,
    residual, concat and the 2x upsample (band [a, b) -> [2a, 2b)) read no
    other rows. An attention node reads every row: it has no band."""
    from alpha_yolo_quant_torch.models.graph import (
        AttentionNode, ConvNode, MaxPoolNode,
    )

    if isinstance(node, ConvNode):
        if node.kernel == 1 and node.stride == 1 and node.padding == 0:
            return None
        if node.kernel == 3 and node.padding == 1 and node.stride in (1, 2):
            return (1, 1, 1) if node.stride == 1 else (2, 0, 2)
    elif isinstance(node, MaxPoolNode):
        if node.stride == 1 and node.kernel == 2 * node.padding + 1:
            return node.padding, node.padding, 1
    elif not isinstance(node, AttentionNode):
        return None
    raise ValueError(f"{type(node).__name__} -> {node.dst}: no height-band "
                     "rule for this geometry")


def _widen(t: torch.Tensor, h: int, lo: int, hi: int, top: int, bot: int,
           group, i: int, n: int) -> torch.Tensor:
    """Rows [lo, hi) of an NHWC edge of height h whose bands of h/n rows
    lie on the group's n ranks in order, t being rank i's band. Every rank
    sends each other rank the rows of its band that the other's window
    (band widened by top/bot, clipped to the image) needs, and receives
    its own window's rows in one batch of point-to-point ops."""
    k = h // n
    ops, pieces = [], {}
    for q in range(n):
        if q == i:
            continue
        q_lo, q_hi = max(q * k - top, 0), min((q + 1) * k + bot, h)
        r0, r1 = max(q_lo, i * k), min(q_hi, (i + 1) * k)
        if r0 < r1:
            ops.append(dist.P2POp(
                dist.isend, _to_wire(t[:, r0 - i * k:r1 - i * k], group),
                _peer(group, q), group))
        r0, r1 = max(lo, q * k), min(hi, (q + 1) * k)
        if r0 < r1:
            buf = torch.empty((t.shape[0], r1 - r0) + tuple(t.shape[2:]),
                              device=_wire_device(group),
                              dtype=_wire_dtype(t.dtype))
            pieces[q] = buf
            ops.append(dist.P2POp(dist.irecv, buf, _peer(group, q), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    parts = [t if q == i else pieces[q].to(device=t.device, dtype=t.dtype)
             for q in range(n) if q == i or q in pieces]
    return torch.cat(parts, 1)


def banded_forward(model, plan, x_q: torch.Tensor, mesh: DeviceMesh,
                   axis: str = "sp") -> Dict[str, torch.Tensor]:
    """The fused-engine forward with every edge's rows banded over the
    ``axis`` ranks: rank i of n holds rows [i*h/n, (i+1)*h/n) of each edge
    of height h. A node that reads rows beyond its band (``_halo``) runs
    the unchanged kernel on the band widened by its neighbours' rows and
    keeps its own output rows; at the image's top and bottom the kernels'
    own padding applies. Integer ops on the same inputs give the same
    outputs, so the bands equal the unsharded edges' rows bit for bit.
    Returns the six head edges whole on every rank (all-gathered along H),
    NCHW, head-requantized for a full-quant model: what int_forward
    (head_requant=full) returns. x_q: the whole quantized batch, NCHW."""
    from alpha_yolo_quant_torch.models.graph import edge_shapes
    from alpha_yolo_quant_torch.runtime.interpreter import (
        requant_heads, run_node,
    )

    graph = model.graph
    group = mesh.get_group(axis)
    i, n = axis_coord(mesh, axis)
    heights = {e: s[1] for e, s in edge_shapes(graph, x_q.shape[2]).items()}

    def band(e):
        k = heights[e] // n
        return i * k, (i + 1) * k

    a, b = band(graph.input_edge)
    env = {graph.input_edge: x_q[:, :, a:b].permute(0, 2, 3, 1).contiguous()}
    for idx, node in enumerate(graph.nodes):
        halo = _halo(node)
        if halo is None:
            run_node(model, plan, idx, env)
            continue
        top, bot, stride = halo
        h = heights[node.src]
        a, b = band(node.src)
        lo, hi = max(a - top, 0), min(b + bot, h)
        wide = {node.src: _widen(env[node.src], h, lo, hi, top, bot, group,
                                 i, n)}
        run_node(model, plan, idx, wide)
        a_d, b_d = band(node.dst)
        off = lo // stride
        env[node.dst] = wide[node.dst][:, a_d - off:b_d - off].contiguous()
    outs = {role: _all_gather_cat(env[e], group, 1).permute(0, 3, 1, 2)
            .contiguous() for role, e in graph.outputs.items()}
    return requant_heads(model, plan, outs) if model.cfg.full_quant else outs


def spatial_parallel_fn(model, mesh: DeviceMesh, axis: str = "sp",
                        dfl_w_float=None, device="cuda"):
    """Latency-mode sharding: the with_nms=False pipeline (quantize, head
    edges, decode) with every image's height banded over ``axis``
    (banded_forward). Returns fn(images) -> the preds of the whole batch,
    replicated on every rank of the axis (JAX pins them with
    out_shardings=P()), equal to build_int_pipeline(with_nms=False)'s bit
    for bit. ``dfl_w_float``: the float DFL weights a partial-quant model's
    float head needs. The axis's size must divide the deepest feature-map
    height, image_size/32, as in JAX."""
    from alpha_yolo_quant_torch.runtime.interpreter import build_int_pipeline

    _, n = axis_coord(mesh, axis)
    deepest = model.cfg.image_size // 32
    if deepest % n:
        raise ValueError(f"sp={n} must divide the deepest feature-map height "
                         f"image_size/32 = {deepest}")
    warm_up(mesh.get_group(axis))
    fn, _ = build_int_pipeline(
        model, device, dfl_w_float=dfl_w_float, with_nms=False,
        forward=lambda plan, x_q: banded_forward(model, plan, x_q, mesh,
                                                 axis))
    return fn


def dp_sp_parallel_fn(model, mesh: DeviceMesh, dp_axis: str = "dp",
                      sp_axis: str = "sp", dfl_w_float=None, device="cuda"):
    """The batch's rows over ``dp_axis`` and every image's height over
    ``sp_axis`` of a 2-D mesh: each dp group runs spatial_parallel_fn on
    its rows. Returns fn(images) -> this dp group's preds (batch-sharded
    over dp_axis, as JAX's out_specs=P(dp_axis); gather_batch assembles
    them)."""
    return data_parallel_step(
        spatial_parallel_fn(model, mesh, sp_axis, dfl_w_float, device),
        mesh, dp_axis)
