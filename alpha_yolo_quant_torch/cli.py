"""Pipeline CLI of the PyTorch port: prepare -> calibrate -> serve
(counterpart of alpha_yolo_quant_tpu/cli.py, same argument names and
defaults, same files and output lines).

  prepare    load checkpoint, fuse BatchNorm, save fused params
  calibrate  activation statistics -> max_a_all.txt + max_a.txt
  serve      batch-coalescing inference over an image list (JSONL out)

calibrate and serve run on ``--device`` (default ``cuda``): without a card
they stop unless ``--device cpu`` is given. serve's ``--engine`` is one of
the port's engines (fused, pallas, packed). serve reads image files with
PIL; where PIL is absent, drive serving.BatchCoalescer with in-memory
arrays instead.

Run as: python -m alpha_yolo_quant_torch.cli <command> [flags]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _cfg(args):
    from alpha_yolo_quant_torch.config import QuantConfig

    return QuantConfig(model=args.model, k=args.k,
                       calib_mode=getattr(args, "mode", "max"),
                       full_quant=getattr(args, "full_quant", False),
                       image_size=args.image_size)


def _device(args):
    """The torch device the command runs on; refuses cuda without a
    card rather than carrying on on the CPU."""
    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{args.cmd}: no CUDA device; pass --device cpu "
                         "to run on the CPU")
    return dev


def _results_dir(out: str) -> str:
    path = os.path.join(out, "results")
    os.makedirs(path, exist_ok=True)
    return path


def _graph_params(args, cfg):
    from alpha_yolo_quant_torch.models.graph import build_yolov8_graph
    from alpha_yolo_quant_torch.models.params import init_params
    from alpha_yolo_quant_torch.utils.params_io import load_params

    graph = build_yolov8_graph(cfg)
    if getattr(args, "weights", None):
        params = load_params(args.weights)
    else:
        print("NOTE: no --weights given; using random init", file=sys.stderr)
        params = init_params(graph, seed=0)
    return graph, params


def _calib_batches(args, cfg):
    if args.coco_images and args.coco_ann:
        from alpha_yolo_quant_torch.data.coco import CocoValDataset, batches

        ds = CocoValDataset(args.coco_images, args.coco_ann,
                            limit=args.limit)
        for imgs, _ in batches(ds, args.batch_size, cfg.image_size):
            yield imgs
    else:
        print("NOTE: no COCO path; using synthetic calibration batches",
              file=sys.stderr)
        rng = np.random.default_rng(0)
        for _ in range(max(1, (args.limit or 8) // args.batch_size)):
            yield rng.uniform(0, 1, (args.batch_size, 3, cfg.image_size,
                                     cfg.image_size)).astype(np.float32)


def cmd_prepare(args):
    from alpha_yolo_quant_torch.models.graph import build_yolov8_graph
    from alpha_yolo_quant_torch.models.params import (
        fuse_batchnorm, init_raw_params, load_torch_checkpoint,
    )
    from alpha_yolo_quant_torch.utils.params_io import save_params

    cfg = _cfg(args)
    graph = build_yolov8_graph(cfg)
    if args.checkpoint:
        raw = load_torch_checkpoint(graph, args.checkpoint)
    else:
        print("NOTE: no --checkpoint; random raw params", file=sys.stderr)
        raw = init_raw_params(graph, seed=0)
    fused = fuse_batchnorm(graph, raw)
    path = os.path.join(_results_dir(args.out), "weights_batchnf.npz")
    save_params(fused, path)
    print(f"fused params -> {path}")


def cmd_calibrate(args):
    from alpha_yolo_quant_torch.quantize.calibrate import (
        DEFAULT_MIN_MAE_KOEF, collect_samples, collect_stats, load_batches,
        reduce_stats, save_batches,
    )
    from alpha_yolo_quant_torch.utils.io import write_max_a, write_max_a_all

    cfg = _cfg(args)
    device = _device(args)
    graph, params = _graph_params(args, cfg)
    records = collect_stats(graph, params, _calib_batches(args, cfg),
                            device)
    samples = None
    if cfg.calib_mode.lower() == "min_mae":
        # the stem conv's koef is fixed, not searched (the reference dumps
        # no batches for conv_p1), so skip its samples
        taps = [c.tap for c in graph.convs()
                if c.tap and c.tap not in DEFAULT_MIN_MAE_KOEF]
        # resumable: reuse persisted batches/ dumps when present, else
        # capture and persist them (reference utils/save_weights.py:13-21)
        samples = load_batches(args.out, taps)
        if samples is None:
            samples = collect_samples(graph, params,
                                      _calib_batches(args, cfg), taps,
                                      device)
            save_batches(args.out, samples)
            print(f"activation dumps -> {args.out}/batches/")
        else:
            print(f"resumed activation dumps from {args.out}/batches/")
    max_a = reduce_stats(records, cfg.calib_mode, cfg.k, samples)
    results = _results_dir(args.out)
    write_max_a_all(os.path.join(results, "max_a_all.txt"),
                    {k: v for k, v in records.items()
                     if not k.startswith("_")})
    path = os.path.join(results, "max_a.txt")
    write_max_a(path, max_a)
    print(f"calibration ({cfg.calib_mode}) -> {path}")


def cmd_serve(args):
    """Batch-coalescing inference over a list of images: decode on a host
    thread pool, submit each image to serving.BatchCoalescer, emit one
    JSON line per image: {"path", "n", "detections": [[x1,y1,x2,y2,
    conf,cls], ...]}, or {"path", "error"}. Returns 1 if an image
    failed."""
    import concurrent.futures as cf
    import json

    from alpha_yolo_quant_torch.data.coco import load_image_square
    from alpha_yolo_quant_torch.quantize.transform import (
        build_quantized_model,
    )
    from alpha_yolo_quant_torch.runtime.interpreter import build_int_pipeline
    from alpha_yolo_quant_torch.serving import BatchCoalescer
    from alpha_yolo_quant_torch.utils.io import read_max_a

    cfg = _cfg(args)
    device = _device(args)
    graph, params = _graph_params(args, cfg)
    model = build_quantized_model(graph, params, read_max_a(args.max_a),
                                  cfg)
    fn, _ = build_int_pipeline(model, device, dfl_w_float=params["dfl"]["w"],
                               engine=args.engine)
    src = sys.stdin if args.input_list == "-" else open(args.input_list)
    with src:
        paths = [ln.strip() for ln in src if ln.strip()]
    results = [None] * len(paths)
    errors = [None] * len(paths)
    shape = (3, cfg.image_size, cfg.image_size)
    with BatchCoalescer(fn, max_batch=args.max_batch,
                        max_wait_ms=args.max_wait_ms,
                        image_shape=shape) as co:
        def one(i, path):
            # a decode (or step) failure is reported per image; the run
            # goes on serving the others
            try:
                img = load_image_square(path, cfg.image_size)[None]
                det, n_det = co.submit(img).result()
                return i, det[0][: int(n_det[0])], None
            except Exception as e:
                return i, None, f"{type(e).__name__}: {e}"

        with cf.ThreadPoolExecutor(args.decoders) as pool:
            futs = [pool.submit(one, i, p) for i, p in enumerate(paths)]
            for f in cf.as_completed(futs):
                i, det, err = f.result()
                results[i], errors[i] = det, err
        stats = co.snapshot()
    out = open(args.output, "w") if args.output else sys.stdout
    n_failed = 0
    try:
        for path, det, err in zip(paths, results, errors):
            if err is not None:
                n_failed += 1
                out.write(json.dumps({"path": path, "error": err}) + "\n")
                continue
            out.write(json.dumps({
                "path": path,
                "n": int(len(det)),
                "detections": [[round(float(v), 4) for v in row]
                               for row in det],
            }) + "\n")
    finally:
        if args.output:
            out.close()
    print(f"served {len(paths) - n_failed}/{len(paths)} images"
          + (f" -> {args.output}" if args.output else "")
          + f" | {stats['flushes']} steps, mean fill "
          f"{stats['mean_fill']:.2f}, latency p50/p95 "
          f"{stats['latency_ms_p50']:.1f}/{stats['latency_ms_p95']:.1f} ms"
          + (f" | {n_failed} FAILED" if n_failed else ""),
          file=sys.stderr)
    return 1 if n_failed else 0


def build_parser():
    p = argparse.ArgumentParser(prog="alpha_yolo_quant_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, weights=True, device=True):
        sp.add_argument("--model", default="yolov8n",
                        choices=["yolov8n", "yolov8s", "yolov8m", "yolov8l",
                                 "yolov8x"])
        sp.add_argument("--k", type=int, default=8)
        sp.add_argument("--image-size", type=int, default=640)
        sp.add_argument("--out", default="artifacts/8_nano")
        if weights:
            sp.add_argument("--weights", help="fused params .npz")
        if device:
            sp.add_argument("--device", default="cuda",
                            help="torch device (cuda, or cpu)")

    sp = sub.add_parser("prepare", help="load checkpoint + fuse BatchNorm")
    common(sp, weights=False, device=False)
    sp.add_argument("--checkpoint", help="torch .pt state dict")
    sp.set_defaults(fn=cmd_prepare)

    sp = sub.add_parser("calibrate", help="activation statistics -> max_a")
    common(sp)
    sp.add_argument("--mode", default="max")
    sp.add_argument("--coco-images")
    sp.add_argument("--coco-ann")
    sp.add_argument("--limit", type=int, default=None)
    sp.add_argument("--batch-size", type=int, default=8)
    sp.set_defaults(fn=cmd_calibrate)

    sp = sub.add_parser("serve",
                        help="batch-coalescing inference over an image "
                             "list (JSONL detections out)")
    common(sp)
    sp.add_argument("--max-a", required=True)
    sp.add_argument("--full-quant", action="store_true")
    sp.add_argument("--engine", default="fused",
                    choices=["fused", "pallas", "packed"])
    sp.add_argument("--input-list", required=True,
                    help="file of image paths, one per line ('-' = stdin)")
    sp.add_argument("--output", help="JSONL out (default stdout)")
    sp.add_argument("--max-batch", type=int, default=128)
    sp.add_argument("--max-wait-ms", type=float, default=5.0)
    sp.add_argument("--decoders", type=int, default=8,
                    help="host image-decode threads feeding the batcher")
    sp.set_defaults(fn=cmd_serve)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    ret = args.fn(args)
    return ret if isinstance(ret, int) else 0


if __name__ == "__main__":
    sys.exit(main())
