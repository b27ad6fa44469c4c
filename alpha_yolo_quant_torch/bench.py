"""Throughput of the whole serving pipeline on one card: images in,
detections out.

    python -m alpha_yolo_quant_torch.bench [--engine fused|pallas|packed]
        [--batch 128] [--iters 10] [--input f32|u8] [--coalesce N]
        [--model yolov8n] [--k 8] [--image-size 640] [--device cuda]

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

Left out of bench.py on purpose: vs_baseline and --check (their numbers
are TPU ones), the yolov8n mid-batch pad_batch_to=128 policy (a TPU lane
choice) and --dp.
"""

from __future__ import annotations

import json
import statistics
import sys
import time

import numpy as np

INT8_PEAK_OPS = 1.979e15   # one H100 SXM, dense int8 tensor ops/s
WARMUP = 2
REPEATS = 3


def metric_name(model: str, image_size: int, k: int, coalesce: int,
                batch: int, input_dtype: str) -> str:
    metric = f"{model}_{image_size}_int{k}_e2e"
    if coalesce:
        metric += f"_co{coalesce}x{batch}"
    if input_dtype == "u8":
        metric += "_u8"
    return metric


def main(model="yolov8n", k=8, image_size=640, engine="fused", batch=128,
         iters=10, input_dtype="f32", coalesce=0, device="cuda") -> dict:
    """Run the protocol above, print its lines and return the JSON
    line's dict. A CUDA device without a card stops (SystemExit)."""
    import torch

    from alpha_yolo_quant_torch.engine_profile import build_model
    from alpha_yolo_quant_torch.models.graph import node_costs
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline,
    )
    from alpha_yolo_quant_torch.utils.profiling import card_name

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device; pass --device cpu to run "
                         "on the CPU")
    if input_dtype not in ("f32", "u8"):
        raise ValueError(f"input_dtype {input_dtype!r}: f32 or u8")
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

    for _ in range(WARMUP):
        fn(*images)
    host_ms, event_ms = [], []
    for _ in range(REPEATS):
        if on_card:
            torch.cuda.synchronize(dev)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            e0.record()
            acc = repeat()
            e1.record()
            float(acc)
            host_ms.append((time.perf_counter() - t0) / iters * 1e3)
            event_ms.append(e0.elapsed_time(e1) / iters)
        else:
            t0 = time.perf_counter()
            float(repeat())
            host_ms.append((time.perf_counter() - t0) / iters * 1e3)
    ms = statistics.median(host_ms)
    img_s = batch * n_inputs / ms * 1e3
    macs = sum(node_costs(qmodel.graph, image_size))
    name = card_name(dev) if on_card else "cpu"
    ev = (f"{statistics.median(event_ms):.4f} ms by CUDA events "
          f"(min {min(event_ms):.4f}, max {max(event_ms):.4f})"
          if on_card else "no CUDA events (CPU)")
    print(f"bench: {name} engine {engine}: {ms:.4f} ms per call of "
          f"{batch * n_inputs} images by host clock (min {min(host_ms):.4f},"
          f" max {max(host_ms):.4f}, {REPEATS} repeats of {iters}); {ev}",
          file=sys.stderr, flush=True)
    line = {"metric": metric_name(model, image_size, k, coalesce, batch,
                                  input_dtype),
            "value": round(img_s, 2), "unit": "img/s",
            "mfu": (round(img_s * 2.0 * macs / INT8_PEAK_OPS, 6) if on_card
                    else None),
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
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--input", choices=["f32", "u8"], default="f32",
                    help="image ingest dtype: f32 [0,1] tensors or uint8 "
                         "pixels normalized on the device")
    ap.add_argument("--coalesce", type=int, default=0,
                    help="N coalesced requests of --batch images per call")
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu)")


def run(args) -> dict:
    return main(model=args.model, k=args.k, image_size=args.image_size,
                engine=args.engine, batch=args.batch, iters=args.iters,
                input_dtype=args.input, coalesce=args.coalesce,
                device=args.device)


if __name__ == "__main__":
    run(build_parser().parse_args())
