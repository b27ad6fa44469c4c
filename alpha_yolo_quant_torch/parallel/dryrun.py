"""Multi-rank smoke run of every parallel seam against the single-rank run
(the port's analog of __graft_entry__.dryrun_multichip).

    python -m alpha_yolo_quant_torch.parallel.dryrun [N] [--device cuda|cpu]

``dryrun_multichip(n, device)`` spawns n ranks: one NCCL rank per card for
``device="cuda"`` (the default; it stops when fewer than n cards are
visible), gloo ranks on the CPU for ``"cpu"``. The yolov8n K=8 full-quant
model (64 px, random weights from a seed, calibrated by the port's float
forward on ``device``) is built once here and passed to the ranks. Each
rank then checks, against the same computation run on one rank:

- dp serving: the full-quant pipeline over the n-rank batch, bit for bit;
- the dp calibration all-reduce: every tap's global max within rtol 1e-6;
- tp (n >= 4): float preds on an (n/2, 2) dp x tp mesh within rtol = atol
  = 2e-4, JAX's tolerance;
- sp = 2 (n >= 2): the with_nms=False preds, bit for bit;
- dp x sp (n >= 4): a (2, 2) mesh, bit for bit;
- pp (n >= 4): four stages, one image per microbatch, four microbatches,
  detections bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

SIZE = 64


def _model(device: str):
    """(graph, params, full-quant model), 64 px, calibrated on device."""
    from alpha_yolo_quant_torch.config import QuantConfig
    from alpha_yolo_quant_torch.models.graph import build_yolov8_graph
    from alpha_yolo_quant_torch.models.params import init_params
    from alpha_yolo_quant_torch.quantize.calibrate import (
        collect_stats, reduce_stats,
    )
    from alpha_yolo_quant_torch.quantize.transform import (
        build_quantized_model,
    )

    cfg = QuantConfig(model="yolov8n", k=8, full_quant=True,
                      image_size=SIZE)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=0)
    max_a = reduce_stats(collect_stats(graph, params, [_images(1, 2)],
                                       device), "max")
    return graph, params, build_quantized_model(graph, params, max_a, cfg)


def _images(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(
        0, 1, (n, 3, SIZE, SIZE)).astype(np.float32)


def _equal(got, want, what: str) -> None:
    for g, w in zip(got, want) if isinstance(want, tuple) else [(got, want)]:
        if not torch.equal(g.cpu(), w.cpu()):
            raise AssertionError(f"{what} differs from the single-rank run")


def _rank(rank: int, n: int, graph, params, model) -> dict:
    import torch.distributed as dist

    from alpha_yolo_quant_torch.models.forward import forward_float
    from alpha_yolo_quant_torch.models.head import decode_float
    from alpha_yolo_quant_torch.models.params import params_to_torch
    from alpha_yolo_quant_torch.parallel.mesh import (
        data_parallel_step, dp_sp_parallel_fn, gather_batch, in_mesh,
        make_mesh, make_mesh_2d, shard_params_tp, sharded_forward_fn,
        spatial_parallel_fn, tensor_parallel_fn,
    )
    from alpha_yolo_quant_torch.parallel.pipeline import build_pp_pipeline
    from alpha_yolo_quant_torch.postprocess.nms import (
        non_max_suppression, q_nms_params,
    )
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline, decode_full_quant, device_plan, int_forward,
        quantize_input,
    )

    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    done = []

    # dp serving
    mesh = make_mesh(n)
    fn, _ = build_int_pipeline(model, dev)
    imgs = _images(0, n)
    got = gather_batch(mesh, data_parallel_step(fn, mesh)(imgs))
    _equal(got, fn(imgs), "dp serving")
    if got[0].shape != (n, 300, 6):
        raise AssertionError(f"dp serving: shape {tuple(got[0].shape)}")
    done.append(f"dp{n}")

    # calibration with the cross-rank tap all-reduce
    tp = params_to_torch(params, dev)
    out = sharded_forward_fn(graph, mesh, collect_taps=True)(tp, imgs)
    with torch.no_grad():
        _, taps = forward_float(graph, tp, torch.as_tensor(imgs, device=dev),
                                collect_taps=True)
    for name, v in taps.items():
        np.testing.assert_allclose(float(out["taps"][name]),
                                   float(torch.amax(v)), rtol=1e-6,
                                   err_msg=name)
    done.append("calibration")

    if n >= 4 and n % 2 == 0:    # dp x tp
        mesh2 = make_mesh_2d(n // 2, 2)
        x = _images(1, n // 2)
        preds = gather_batch(mesh2, tensor_parallel_fn(
            graph, mesh2, dp_axis="dp")(shard_params_tp(mesh2, tp), x))
        with torch.no_grad():
            outs, _ = forward_float(graph, tp, torch.as_tensor(x, device=dev))
            want = decode_float(outs, tp["dfl"]["w"])
        np.testing.assert_allclose(preds.cpu().numpy(), want.cpu().numpy(),
                                   rtol=2e-4, atol=2e-4)
        done.append(f"dp{n // 2}xtp2")

    if n >= 2:   # sp = 2, the with_nms=False preds
        ref, _ = build_int_pipeline(model, dev, with_nms=False)
        mesh_sp = make_mesh(2, axis="sp")
        x = _images(2, 2)
        if in_mesh(mesh_sp):
            _equal(spatial_parallel_fn(model, mesh_sp, device=dev)(x),
                   ref(x), "sp=2 preds")
        done.append("sp2")
        if n >= 4:
            mesh_dpsp = make_mesh_2d(2, 2, axes=("dp", "sp"))
            x = _images(3, 4)
            got = gather_batch(mesh_dpsp, dp_sp_parallel_fn(
                model, mesh_dpsp, device=dev)(x))
            _equal(got, ref(x), "dp x sp preds")
            done.append("dp2xsp2")

    if n >= 4:   # pp, four stages
        mesh_pp = make_mesh(4, axis="pp")
        x = _images(4, 4)
        if in_mesh(mesh_pp):
            fn_pp, spec = build_pp_pipeline(model, mesh_pp, n_stages=4,
                                            microbatch=1, n_microbatches=4,
                                            device=dev)
            plan = device_plan(model, dev)
            outs = int_forward(model, plan, quantize_input(
                torch.as_tensor(x, device=dev), model.cfg.k),
                head_requant=True)
            want = non_max_suppression(
                decode_full_quant(model, plan, outs),
                q_nms_params(model.head.anchor_scale))
            _equal(fn_pp(x), want, "pp detections")
        done.append("pp4")
    return {"world": n, "checks": done}


def dryrun_multichip(n: int, device: str = "cuda") -> dict:
    """Run every seam above on n ranks; raises on any mismatch. Returns
    {"world", "checks"}."""
    from alpha_yolo_quant_torch.parallel.mesh import run_ranks

    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: cpu or cuda")
    if device == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n > visible:
            raise SystemExit(f"dryrun_multichip({n}): only {visible} CUDA "
                             "devices visible; device='cpu' runs gloo ranks "
                             "on the CPU")
    graph, params, model = _model(device)
    return run_ranks(_rank, (n, graph, params, model), n,
                     "nccl" if device == "cuda" else "gloo",
                     deadline_s=900)


if __name__ == "__main__":
    import argparse
    import json

    ap = argparse.ArgumentParser(prog="python -m "
                                 "alpha_yolo_quant_torch.parallel.dryrun")
    ap.add_argument("n", type=int, nargs="?", default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args()
    print(json.dumps(dryrun_multichip(a.n, a.device)))
