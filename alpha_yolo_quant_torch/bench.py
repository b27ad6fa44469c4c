"""Throughput of the whole serving pipeline on one card: images in,
detections out.

    python -m alpha_yolo_quant_torch.bench [--engine fused|pallas|packed]
        [--batch 128] [--iters 10] [--input f32|u8] [--coalesce N]
        [--model yolov8n] [--k 8] [--image-size 640] [--device cuda]
        [--dp N]

The configuration is the JAX package's bench.py: full quant, random
weights from init_params(seed=0), calibrated by the port's float forward
on two images from default_rng(1), images from default_rng(0) (f32 in
[0, 1], or their uint8 rounding with --input u8) made once on the device.
With --coalesce N the pipeline takes N requests of --batch images each
per call (build_int_pipeline(coalesce_requests=N)).

Timing: warm-up calls, a synchronize, then three repeats of ``iters``
calls, each call adding one element of every output leaf into a device
scalar that is read once after its repeat (so no output goes
unconsumed); the host clock and CUDA events around each repeat. The JSON
line reports the median repeat by host clock; the line before it, on
stderr, the card (its name and power limit), the engine, the batch ms by
host clock and by events, and the repeats' min and max.

Prints one JSON line: {"metric", "value" (img/s), "unit", "mfu",
"device"}. ``metric`` is named as bench.py names it
({model}_{size}_int{k}_e2e, then _co{N}x{B}, then _u8). ``mfu`` is img/s
times 2 x the conv MACs of one image (models.graph.node_costs) over the
dense int8 tensor peak of one H100 SXM, 1,979e12 operations/s, the whole
pipeline (quantize, decode, q_NMS) in the denominator's time. ``device``
is the card's name, or "cpu" when the CPU was asked for: a CPU run's
numbers are never a card's, and its mfu is null.

With --dp N (bench.py's dp protocol) the batch is global, 128 x N by
default, and each of N ranks runs its rows: NCCL ranks, one per card, for
``--device cuda``, gloo ranks on the CPU for ``--device cpu``, spawned
here unless a launcher (torchrun) started them. Every rank runs the
repeats above; a barrier before and after each repeat makes rank 0's
host clock span the slowest rank. ``value`` is the aggregate img/s over
the global batch, ``mfu`` counts one card's share (value / N), and the
metric gets _dp{N} after _co/before _u8 for N > 1 (N = 1 keeps the base
name). Only rank 0 prints.

Left out of bench.py on purpose: vs_baseline and --check (their numbers
are TPU ones), and the yolov8n mid-batch pad_batch_to=128 policy (a TPU
lane choice).
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

INT8_PEAK_OPS = 1.979e15   # one H100 SXM, dense int8 tensor ops/s
WARMUP = 2
REPEATS = 3


def metric_name(model: str, image_size: int, k: int, coalesce: int,
                batch: int, input_dtype: str, dp: int = 0) -> str:
    metric = f"{model}_{image_size}_int{k}_e2e"
    if coalesce:
        metric += f"_co{coalesce}x{batch}"
    if dp > 1:
        metric += f"_dp{dp}"
    if input_dtype == "u8":
        metric += "_u8"
    return metric


def main(model="yolov8n", k=8, image_size=640, engine="fused", batch=None,
         iters=10, input_dtype="f32", coalesce=0, device="cuda",
         dp=0) -> dict:
    """Run the protocol above, print its lines and return the JSON
    line's dict (None on ranks other than 0). A CUDA device without a
    card stops (SystemExit)."""
    import torch
    import torch.distributed as dist

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; pass --device cpu to run "
                         "on the CPU")
    if input_dtype not in ("f32", "u8"):
        raise ValueError(f"input_dtype {input_dtype!r}: f32 or u8")
    if batch is None:
        batch = 128 * max(dp, 1)
    if dp:
        if coalesce:
            raise SystemExit("--dp composes with --coalesce through "
                             "serving.BatchCoalescer, not the bench harness")
        if batch % dp:
            raise SystemExit(f"--dp {dp} must divide --batch {batch}")
        if not dist.is_initialized():
            from alpha_yolo_quant_torch.parallel.mesh import (
                init_distributed, run_ranks,
            )

            backend = "nccl" if on_card else "gloo"
            if on_card and dp > torch.cuda.device_count():
                raise SystemExit(f"--dp {dp}: only "
                                 f"{torch.cuda.device_count()} devices "
                                 "visible")
            kw = dict(model=model, k=k, image_size=image_size, engine=engine,
                      batch=batch, iters=iters, input_dtype=input_dtype,
                      device=device, dp=dp)
            if "WORLD_SIZE" not in os.environ:
                return run_ranks(_rank, (kw,), dp, backend,
                                 deadline_s=float("inf"))
            rank_dev = init_distributed(backend)
            if on_card:
                dev = rank_dev
    return _run(model, k, image_size, engine, batch, iters, input_dtype,
                coalesce, dev, dp)


def _rank(rank: int, kw: dict):
    import torch

    if torch.device(kw["device"]).type == "cuda":
        kw = dict(kw, device=f"cuda:{rank}")
    return main(**kw)


def _run(model, k, image_size, engine, batch, iters, input_dtype, coalesce,
         dev, dp):
    import torch
    import torch.distributed as dist

    from alpha_yolo_quant_torch.engine_profile import build_model
    from alpha_yolo_quant_torch.models.graph import node_costs
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline,
    )
    from alpha_yolo_quant_torch.utils.profiling import card_name

    on_card = dev.type == "cuda"
    lead = not dp or dist.get_rank() == 0
    qmodel = build_model(image_size, dev, model=model, k=k)
    n_inputs = coalesce or 1
    fn, _ = build_int_pipeline(qmodel, dev, engine=engine,
                               coalesce_requests=coalesce or None)
    rng = np.random.default_rng(0)
    images = []
    for _ in range(n_inputs):
        im = rng.uniform(0, 1, (batch, 3, image_size, image_size)).astype(
            np.float32)
        if input_dtype == "u8":
            im = np.round(im * 255.0).astype(np.uint8)
        if dp:   # this rank's contiguous rows
            from alpha_yolo_quant_torch.parallel.mesh import (
                make_mesh, shard_batch,
            )

            im = shard_batch(make_mesh(dp), im)
        images.append(torch.as_tensor(im, device=dev))

    def leaves(out):
        if isinstance(out, torch.Tensor):
            return [out]
        return [t for o in out for t in leaves(o)]

    def repeat():
        acc = torch.zeros((), dtype=torch.float64, device=dev)
        for _ in range(iters):
            for leaf in leaves(fn(*images)):
                acc += leaf.reshape(-1)[0]
        return acc

    def barrier():
        if dp:
            dist.barrier()

    for _ in range(WARMUP):
        fn(*images)
    host_ms, event_ms = [], []
    for _ in range(REPEATS):
        if on_card:
            torch.cuda.synchronize(dev)
            barrier()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            acc = repeat()
            e1.record()
            float(acc)
            barrier()
            host_ms.append((time.perf_counter() - t0) / iters * 1e3)
            event_ms.append(e0.elapsed_time(e1) / iters)
        else:
            barrier()
            t0 = time.perf_counter()
            float(repeat())
            barrier()
            host_ms.append((time.perf_counter() - t0) / iters * 1e3)
    if not lead:
        return None
    ms = statistics.median(host_ms)
    img_s = batch * n_inputs / ms * 1e3
    macs = sum(node_costs(qmodel.graph, image_size))
    name = card_name(dev) if on_card else "cpu"
    ev = (f"{statistics.median(event_ms):.4f} ms by CUDA events "
          f"(min {min(event_ms):.4f}, max {max(event_ms):.4f})"
          if on_card else "no CUDA events (CPU)")
    ranks = f" over {dp} ranks" if dp else ""
    print(f"bench: {name} engine {engine}: {ms:.4f} ms per call of "
          f"{batch * n_inputs} images{ranks} by host clock (min "
          f"{min(host_ms):.4f}, max {max(host_ms):.4f}, {REPEATS} repeats "
          f"of {iters}); {ev}", file=sys.stderr, flush=True)
    per_card = img_s / max(dp, 1)
    line = {"metric": metric_name(model, image_size, k, coalesce, batch,
                                  input_dtype, dp),
            "value": round(img_s, 2), "unit": "img/s",
            "mfu": (round(per_card * 2.0 * macs / INT8_PEAK_OPS, 6)
                    if on_card else None),
            "device": (torch.cuda.get_device_name(dev) if on_card
                       else "cpu")}
    print(json.dumps(line), flush=True)
    return line


def build_parser():
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m alpha_yolo_quant_torch.bench",
        description="whole-pipeline throughput on one card")
    add_arguments(ap)
    return ap


def add_arguments(ap) -> None:
    """The bench's options (shared with the CLI's bench subcommand)."""
    ap.add_argument("--model", default="yolov8n",
                    choices=["yolov8n", "yolov8s", "yolov8m", "yolov8l",
                             "yolov8x"])
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--image-size", type=int, default=640)
    ap.add_argument("--engine", default="fused",
                    choices=["fused", "pallas", "packed"])
    ap.add_argument("--batch", type=int, default=None,
                    help="global batch (default 128 per rank)")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--input", choices=["f32", "u8"], default="f32",
                    help="image ingest dtype: f32 [0,1] tensors or uint8 "
                         "pixels normalized on the device")
    ap.add_argument("--coalesce", type=int, default=0,
                    help="N coalesced requests of --batch images per call")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu)")
    ap.add_argument("--dp", type=int, default=0,
                    help="N ranks, each timing its rows of the global "
                         "batch (one card each over NCCL, or gloo on the "
                         "CPU)")


def run(args) -> dict:
    return main(model=args.model, k=args.k, image_size=args.image_size,
                engine=args.engine, batch=args.batch, iters=args.iters,
                input_dtype=args.input, coalesce=args.coalesce,
                device=args.device, dp=args.dp)


if __name__ == "__main__":
    run(build_parser().parse_args())
