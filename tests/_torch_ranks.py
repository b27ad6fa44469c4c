"""Rank functions for the port's multi-rank tests (tests/test_torch_pp.py,
tests/test_torch_parallel.py, tests/test_torch_gpu.py). Each runs on every
rank of a parallel.mesh.run_ranks world and returns, on rank 0, numpy
copies of what the test compares. This module imports torch and the port
only, so that the spawned ranks import neither JAX nor the JAX package
(and the card's tests run where JAX is not installed)."""

import numpy as np
import torch

from alpha_yolo_quant_torch.parallel.mesh import (
    data_parallel_step, dp_sp_parallel_fn, gather_batch, in_mesh, make_mesh,
    make_mesh_2d, replicate, shard_params_tp, sharded_forward_fn,
    spatial_parallel_fn, tensor_parallel_fn,
)
from alpha_yolo_quant_torch.parallel.pipeline import (
    build_pipeline_spec, build_pp_pipeline, pipeline_forward,
)
from alpha_yolo_quant_torch.runtime import fused_ops
from alpha_yolo_quant_torch.runtime.interpreter import (
    build_int_pipeline, device_plan,
)


def host(tree):
    """Numpy copies of every tensor of a tree (dicts, tuples)."""
    if isinstance(tree, dict):
        return {k: host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return tuple(host(v) for v in tree)
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def pp_checks(rank, model, model_pq, dfl_w, images, device="cpu"):
    """Four ranks: pp S=2 (microbatch 2, two microbatches) on ranks 0-1,
    S=4 (one image per microbatch, four), dp x pp 2x2, the batch guard,
    and the full- and partial-quant detections of build_pp_pipeline S=4,
    with each rank's conv kernel launches during the S=4 forward."""
    device = torch.device(device)
    mesh2 = make_mesh(2, axis="pp")
    mesh4 = make_mesh(4, axis="pp")
    mesh22 = make_mesh_2d(2, 2, axes=("dp", "pp"))
    plan = device_plan(model, device)
    res = {}
    if in_mesh(mesh2):
        spec = build_pipeline_spec(model, 2, 2, 2)
        res["s2"] = pipeline_forward(model, plan, spec, mesh2)(images)
    spec = build_pipeline_spec(model, 4, 1, 4)
    fwd = pipeline_forward(model, plan, spec, mesh4)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    fused_ops.reset_counts()
    res["s4"] = fwd(images)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = torch.tensor([fused_ops.LAUNCHES["conv1x1"]
                             + fused_ops.LAUNCHES["conv3x3"]])
    res["launches"] = gather_batch(mesh4, launches, "pp")
    try:
        fwd(images[:3])
    except ValueError as e:
        res["guard"] = str(e)
    spec = build_pipeline_spec(model, 2, 1, 2)
    res["dp_pp"] = gather_batch(mesh22, pipeline_forward(
        model, plan, spec, mesh22, dp_axis="dp")(images))
    fn, _ = build_pp_pipeline(model, mesh4, 4, 1, 4, device=device)
    res["fq_dets"] = fn(images)
    fn, _ = build_pp_pipeline(model_pq, mesh4, 4, 1, 4, dfl_w_float=dfl_w,
                              device=device)
    res["pq_dets"] = fn(images)
    return host(res)


def parallel_checks(rank, graph, params, model, images, device="cpu"):
    """Four ranks: dp over 2 and 4 ranks (detections), the calibration
    taps' MAX all-reduce, tp over 2 ranks and a 2x2 dp x tp mesh (float
    preds), sp over 2 ranks and a 2x2 dp x sp mesh (with_nms=False
    preds), the error of sp over 3 ranks, and what replicate over the 2x2
    mesh leaves on each rank."""
    from alpha_yolo_quant_torch.models.params import params_to_torch

    device = torch.device(device)
    mesh4, mesh2 = make_mesh(4), make_mesh(2)
    mesh_tp = make_mesh(2, axis="tp")
    mesh_dptp = make_mesh_2d(2, 2)
    mesh_sp = make_mesh(2, axis="sp")
    mesh_dpsp = make_mesh_2d(2, 2, axes=("dp", "sp"))
    mesh_sp3 = make_mesh(3, axis="sp")
    res = {}
    fn, _ = build_int_pipeline(model, device)
    res["dp4"] = gather_batch(mesh4, data_parallel_step(fn, mesh4)(images))
    if in_mesh(mesh2):
        res["dp2"] = gather_batch(mesh2,
                                  data_parallel_step(fn, mesh2)(images))
    tp = params_to_torch(params, device)
    res["taps"] = sharded_forward_fn(graph, mesh4, collect_taps=True)(
        tp, images)["taps"]
    if in_mesh(mesh_tp):
        res["tp2"] = tensor_parallel_fn(graph, mesh_tp)(
            shard_params_tp(mesh_tp, tp), images)
    res["dp2tp2"] = gather_batch(mesh_dptp, tensor_parallel_fn(
        graph, mesh_dptp, dp_axis="dp")(shard_params_tp(mesh_dptp, tp),
                                        images))
    if in_mesh(mesh_sp):
        res["sp2"] = spatial_parallel_fn(model, mesh_sp, device=device)(
            images)
    res["dp2sp2"] = gather_batch(mesh_dpsp, dp_sp_parallel_fn(
        model, mesh_dpsp, device=device)(images))
    if in_mesh(mesh_sp3):
        try:
            spatial_parallel_fn(model, mesh_sp3, device=device)
        except ValueError as e:
            res["sp3"] = str(e)
    leaves = {"t": torch.full((2,), rank + 0.5),
              "n": np.full((1,), rank, np.int64)}
    rep = replicate(mesh_dptp, leaves)
    # new leaves of the same kinds; the caller's stay as they were
    assert isinstance(rep["n"], np.ndarray)
    assert leaves["n"][0] == rank and float(leaves["t"][0]) == rank + 0.5
    res["replicated"] = gather_batch(mesh4, torch.cat(
        [rep["t"], torch.as_tensor(rep["n"], dtype=torch.float32)]))
    return host(res)


def card_checks(rank, model, images, sp: int):
    """Gloo ranks sharing cuda:0: pp S=2 over every rank (two microbatches
    of half the batch) and sp over ``sp`` ranks, head edges and preds."""
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    mesh_pp = make_mesh(2, axis="pp")
    mesh_sp = make_mesh(sp, axis="sp")
    plan = device_plan(model, device)
    res = {}
    if in_mesh(mesh_pp):
        b = images.shape[0]
        spec = build_pipeline_spec(model, 2, b // 2, 2)
        res["pp2"] = pipeline_forward(model, plan, spec, mesh_pp)(images)
    if in_mesh(mesh_sp):
        res["sp"] = spatial_parallel_fn(model, mesh_sp, device=device)(
            images)
    return host(res)


def nccl_dp_checks(rank, model, images):
    """NCCL ranks, one per card: the dp serving step on each rank's rows,
    gathered."""
    device = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh()
    fn, _ = build_int_pipeline(model, device)
    return host(gather_batch(mesh, data_parallel_step(fn, mesh)(images)))
