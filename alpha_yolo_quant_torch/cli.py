"""Pipeline CLI of the PyTorch port (counterpart of
alpha_yolo_quant_tpu/cli.py, same argument names and defaults, same files
and output lines):

  prepare    load checkpoint, fuse BatchNorm, save fused params
  calibrate  activation statistics -> max_a_all.txt + max_a.txt
  quantize   build the integer model, golden-image run, export the full
             artifact tree (Verilog txt, pickles, packed weights)
  eval-float fp32 COCO mAP
  eval-int8  quantized COCO mAP (float NMS or full q_NMS)
  serve      batch-coalescing inference over an image list (JSONL out),
             from --weights/--max-a or from an exported tree
  memsim     SRAM allocation simulation (memory.txt, final_memory.txt)
  demo       golden-image smoke test with a detection plot
  info       model/plan summary
  accept     one-command accuracy acceptance (all gates + K sweep)
  bench      whole-pipeline throughput on one card (bench.py)

calibrate, eval-*, serve, demo, accept and bench run on ``--device``
(default ``cuda``): without a card they stop unless ``--device cpu`` is
given. memsim and info are host-only. ``--engine`` is one of the port's
engines (fused, pallas, packed).

``--dp N`` (calibrate, eval-float, eval-int8, serve, accept, bench) runs
the command on N ranks, each on its own rows of every batch: over NCCL
with rank r on ``cuda:r`` (``--device cuda``), or over gloo on the CPU
(``--device cpu``). Without a launcher (no WORLD_SIZE in the environment)
the command spawns the ranks itself; under torchrun each process is one
rank. Rank 0 reads every input, sends each batch to the others and
writes every file and line. The integer pipeline's outputs (eval-int8's
tables, serve's JSONL) equal those of ``--dp 0`` byte for byte; float
results (calibrate, eval-float) can differ in the last bits, as float
convs may round differently at the smaller per-rank batch. Image files are read with PIL and plots
are drawn with matplotlib; where PIL is absent, drive
serving.BatchCoalescer or eval.harness.evaluate with in-memory arrays
instead (demo and memsim --heatmaps need PIL or matplotlib).

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


def _check_dp(args, batch: int) -> None:
    if args.dp and batch % args.dp:
        raise SystemExit(f"--dp {args.dp} must divide the batch size "
                         f"{batch}")


def _on_ranks(args, batch: int):
    """Start or join the ranks of ``--dp N`` (N must divide ``batch``).
    Returns (True, rank 0's result) in a process that spawned N ranks to
    run the command, else (False, None): without --dp, or in a process
    that is (now) a rank. ``--device cuda`` runs NCCL ranks, rank r on
    cuda:r, and stops when fewer than N cards are visible; ``--device
    cpu`` runs gloo ranks."""
    _check_dp(args, batch)
    if not args.dp:
        return False, None
    import torch
    import torch.distributed as dist

    from alpha_yolo_quant_torch.parallel.mesh import (
        init_distributed, run_ranks,
    )

    cuda = torch.device(args.device).type == "cuda"
    if not dist.is_initialized():
        if cuda:
            _device(args)
            n = torch.cuda.device_count()
            if args.dp > n:
                raise SystemExit(f"--dp {args.dp}: only {n} devices visible")
        backend = "nccl" if cuda else "gloo"
        if "WORLD_SIZE" not in os.environ:
            state = {k: v for k, v in vars(args).items() if k != "fn"}
            return True, run_ranks(_cli_rank, (args.fn.__name__, state),
                                   args.dp, backend, deadline_s=float("inf"))
        dev = init_distributed(backend)
        if cuda:
            args.device = str(dev)
    if dist.get_world_size() != args.dp:
        raise SystemExit(f"--dp {args.dp}: the launcher started "
                         f"{dist.get_world_size()} ranks")
    return False, None


def _cli_rank(rank, fn_name, state):
    """One spawned rank of a --dp command: rerun the command here."""
    import torch

    args = argparse.Namespace(**state, fn=globals()[fn_name])
    if torch.device(args.device).type == "cuda":
        args.device = f"cuda:{rank}"
    if rank:
        # rank 0 prints every line; the others would repeat it
        sys.stdout = sys.stderr = open(os.devnull, "w")
    return args.fn(args)


def _controller() -> bool:
    import torch.distributed as dist

    return dist.get_rank() == 0


def _dp_step(fn, args, device, n_calls=None):
    """fn (images -> outputs, per-image rows) sharded over the --dp ranks.
    On rank 0 returns (step, stop): step(images) sends the batch to every
    rank, zero-padded to a multiple of N rows, runs fn on this rank's
    rows, gathers every rank's rows and returns the batch's; after
    ``n_calls`` calls, or at stop(), the other ranks are released. On the
    other ranks it runs fn on each batch rank 0 sends until released, and
    returns None."""
    import torch

    from alpha_yolo_quant_torch.parallel.mesh import (
        BatchFeed, data_parallel_step, gather_batch, make_mesh,
    )
    from alpha_yolo_quant_torch.serving import split_by_sizes

    mesh = make_mesh(args.dp)
    feed = BatchFeed(mesh, device)
    local = data_parallel_step(fn, mesh)
    if not feed.controller:
        for x in feed:
            gather_batch(mesh, local(x))
        return None
    calls, stopped = [0], [False]

    def stop():
        if not stopped[0]:
            stopped[0] = True
            feed.stop()

    def step(images):
        x = torch.as_tensor(images)
        b = x.shape[0]
        pad = -b % args.dp
        if pad:
            x = torch.cat((x, x.new_zeros((pad,) + x.shape[1:])), 0)
        out = gather_batch(mesh, local(feed.send(x)))
        calls[0] += 1
        if calls[0] == n_calls:
            stop()
        return split_by_sizes(out, [b])[0] if pad else out

    return step, stop


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
    from alpha_yolo_quant_torch.export.artifacts import make_dirs
    from alpha_yolo_quant_torch.utils.params_io import save_params

    cfg = _cfg(args)
    graph = build_yolov8_graph(cfg)
    if args.checkpoint:
        raw = load_torch_checkpoint(graph, args.checkpoint)
    else:
        print("NOTE: no --checkpoint; random raw params", file=sys.stderr)
        raw = init_raw_params(graph, seed=0)
    fused = fuse_batchnorm(graph, raw)
    make_dirs(args.out)
    path = os.path.join(args.out, "results", "weights_batchnf.npz")
    save_params(fused, path)
    print(f"fused params -> {path}")


def cmd_calibrate(args):
    from alpha_yolo_quant_torch.quantize.calibrate import (
        DEFAULT_MIN_MAE_KOEF, collect_samples, collect_stats, load_batches,
        reduce_stats, save_batches,
    )
    from alpha_yolo_quant_torch.export.artifacts import make_dirs
    from alpha_yolo_quant_torch.utils.io import write_max_a, write_max_a_all

    spawned, ret = _on_ranks(args, args.batch_size)
    if spawned:
        return ret
    cfg = _cfg(args)
    device = _device(args)
    graph, params = _graph_params(args, cfg)
    records = collect_stats(graph, params, _calib_batches(args, cfg),
                            device, dp=args.dp or None)
    if args.dp and not _controller():
        return 0
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
            make_dirs(args.out)
            save_batches(args.out, samples)
            print(f"activation dumps -> {args.out}/batches/")
        else:
            print(f"resumed activation dumps from {args.out}/batches/")
    max_a = reduce_stats(records, cfg.calib_mode, cfg.k, samples)
    make_dirs(args.out)
    write_max_a_all(os.path.join(args.out, "results", "max_a_all.txt"),
                    {k: v for k, v in records.items()
                     if not k.startswith("_")})
    path = os.path.join(args.out, "results", "max_a.txt")
    write_max_a(path, max_a)
    print(f"calibration ({cfg.calib_mode}) -> {path}")


def cmd_quantize(args):
    from alpha_yolo_quant_torch.data.coco import load_image_square
    from alpha_yolo_quant_torch.export.artifacts import export_all
    from alpha_yolo_quant_torch.quantize.transform import (
        build_quantized_model,
    )
    from alpha_yolo_quant_torch.utils.io import read_max_a
    from alpha_yolo_quant_torch.runtime.golden import golden_forward

    cfg = _cfg(args)
    graph, params = _graph_params(args, cfg)
    max_a = read_max_a(args.max_a)
    model = build_quantized_model(graph, params, max_a, cfg)
    if args.image:
        img = load_image_square(args.image, cfg.image_size)[None]
    else:
        img = np.random.default_rng(0).uniform(
            0, 1, (1, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    env = golden_forward(model, img)
    export_all(model, env, params, args.out)
    print(f"quantized artifacts -> {args.out}")


def _eval_common(args, step, comment, stage, csv_tag):
    """evaluate(step) over --coco-images and the reports; step runs on the
    --dp ranks' rows when --dp is given (only rank 0 reports: the others
    return 0)."""
    from alpha_yolo_quant_torch.data.coco import CocoValDataset
    from alpha_yolo_quant_torch.eval.harness import evaluate
    from alpha_yolo_quant_torch.eval.plots import plot_run_results
    from alpha_yolo_quant_torch.eval.records import save_csv_tables
    from alpha_yolo_quant_torch.export.artifacts import make_dirs
    from alpha_yolo_quant_torch.utils.run_log import write_run_result

    cfg = _cfg(args)
    if args.dp and not _controller():
        _dp_step(step, args, args.device)    # serves rank 0's batches
        return 0
    ds = CocoValDataset(args.coco_images, args.coco_ann, limit=args.limit)
    stop = None
    if args.dp:
        step, stop = _dp_step(step, args, args.device,
                              n_calls=-(-len(ds) // args.batch_size))
    try:
        res = evaluate(step, ds, args.batch_size, cfg.image_size,
                       progress=True, prefetch=args.prefetch,
                       device=args.device)
    finally:
        if stop is not None:
            stop()
    print(f"mAP50-95: {res.map50_95:.4f} over {res.n_images} images "
          f"({res.images_per_s:.1f} img/s device, "
          f"{res.images_per_s_wall:.1f} img/s wall)")
    make_dirs(args.out)
    write_run_result(args.out, res.map50_95, stage, comment)
    # reference reporting contract: per-run det/ann CSV tables + the
    # cross-run mAP plot (stage_3.py:48-49, stage_8_torch.py:1020-1026,
    # utils/plot_run_results.py:29-61)
    ann_p, det_p = save_csv_tables(res.ann_rows, res.det_rows, args.out,
                                   csv_tag)
    print(f"tables -> {ann_p}, {det_p}")
    if stage != 4:
        print(f"run plot -> {plot_run_results(args.out)}")
    return res


def cmd_eval_float(args):
    import torch

    from alpha_yolo_quant_torch.models.forward import forward_float
    from alpha_yolo_quant_torch.models.head import decode_float
    from alpha_yolo_quant_torch.models.params import params_to_torch
    from alpha_yolo_quant_torch.postprocess.nms import (
        NmsParams, non_max_suppression,
    )

    spawned, ret = _on_ranks(args, args.batch_size)
    if spawned:
        return ret
    cfg = _cfg(args)
    device = _device(args)
    graph, params = _graph_params(args, cfg)
    tparams = params_to_torch(params, device)
    nms = NmsParams(conf_thres=args.conf_thres, pre_topk=1000)

    def step(images):
        x = torch.as_tensor(images, dtype=torch.float32, device=device)
        outs, _ = forward_float(graph, tparams, x)
        return non_max_suppression(
            decode_float(outs, tparams["dfl"]["w"]), nms)

    return _eval_common(args, step, "fp32 BN-fused", 4, "orig")


def cmd_eval_int8(args):
    from alpha_yolo_quant_torch.quantize.transform import (
        build_quantized_model,
    )
    from alpha_yolo_quant_torch.utils.io import read_max_a
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline, eval_nms_params,
    )

    spawned, ret = _on_ranks(args, args.batch_size)
    if spawned:
        return ret
    cfg = _cfg(args)
    device = _device(args)
    graph, params = _graph_params(args, cfg)
    model = build_quantized_model(graph, params, read_max_a(args.max_a),
                                  cfg)
    step, _ = build_int_pipeline(
        model, device, dfl_w_float=params["dfl"]["w"],
        nms_params=eval_nms_params(model, args.conf_thres),
        engine=args.engine)
    return _eval_common(args, step,
                        f"int{cfg.k}" + (" full-quant q_NMS"
                                         if cfg.full_quant
                                         else " float NMS"), 7,
                        f"QUANT_{cfg.k}_channel")


def cmd_serve(args):
    """Batch-coalescing inference over a list of images: decode on a host
    thread pool, submit each image to serving.BatchCoalescer, emit one
    JSON line per image: {"path", "n", "detections": [[x1,y1,x2,y2,
    conf,cls], ...]}, or {"path", "error"}. Returns 1 if an image
    failed. With --from-artifacts the model is rebuilt from --out's
    exported tree (the stage-8 load: weight pickles, bias_scales,
    max_a.txt), bit-identical to the model built from the float weights
    (quantize/loadq.py)."""
    from alpha_yolo_quant_torch.quantize.transform import (
        build_quantized_model,
    )
    from alpha_yolo_quant_torch.utils.io import read_max_a
    from alpha_yolo_quant_torch.runtime.interpreter import build_int_pipeline

    spawned, ret = _on_ranks(args, args.max_batch)
    if spawned:
        return ret
    cfg = _cfg(args)
    device = _device(args)
    if args.from_artifacts:
        from alpha_yolo_quant_torch.quantize.loadq import (
            dfl_weights_from_artifacts, model_from_artifacts,
        )

        model = model_from_artifacts(args.out, cfg)
        dfl_w = dfl_weights_from_artifacts(args.out)
    else:
        if not args.max_a:
            raise SystemExit("serve: --max-a is required unless "
                             "--from-artifacts is given")
        graph, params = _graph_params(args, cfg)
        model = build_quantized_model(graph, params,
                                      read_max_a(args.max_a), cfg)
        dfl_w = params["dfl"]["w"]
    fn, _ = build_int_pipeline(model, device, dfl_w_float=dfl_w,
                               engine=args.engine)
    stop = None
    if args.dp:
        # the coalescer lives on rank 0; each flush runs on every rank
        if not _controller():
            _dp_step(fn, args, device)
            return 0
        fn, stop = _dp_step(fn, args, device)
    try:
        return _serve_list(args, cfg, fn)
    finally:
        if stop is not None:
            stop()


def _serve_list(args, cfg, fn):
    """serve's loop over --input-list through a BatchCoalescer of fn."""
    import concurrent.futures as cf
    import json

    from alpha_yolo_quant_torch.data.coco import load_image_square
    from alpha_yolo_quant_torch.serving import BatchCoalescer

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


def cmd_memsim(args):
    from alpha_yolo_quant_torch.export.artifacts import make_dirs
    from alpha_yolo_quant_torch.hwsim.sram import (
        DEFAULT_CELLS, min_buffer_cells, simulate,
    )
    from alpha_yolo_quant_torch.models.graph import build_yolov8_graph

    cfg = _cfg(args)
    graph = build_yolov8_graph(cfg)
    if args.min_buffer:
        # capacity what-if from the static walk
        mc = min_buffer_cells(graph, cfg.image_size)
        peak = simulate(graph, cfg.image_size, 1 << 40).peak_cells
        frag = mc - peak
        print(f"min buffer: {mc} cells ({mc // 8} rows of 8) for "
              f"{cfg.model}@{cfg.image_size} | true peak {peak} cells"
              + (f" (+{frag} first-fit fragmentation)" if frag else
                 " (zero fragmentation: capacity == peak)")
              + f" | reference buffer {DEFAULT_CELLS}: "
              + ("fits" if mc <= DEFAULT_CELLS else "DOES NOT FIT"))
        return 0
    sim = simulate(graph, cfg.image_size)
    make_dirs(args.out)
    sim.write_memory_txt(os.path.join(args.out, "results", "memory.txt"))
    sim.write_final_memory(os.path.join(args.out, "results",
                                        "final_memory.txt"))
    if args.heatmaps:
        from alpha_yolo_quant_torch.eval.plots import plot_memory_heatmaps

        n = plot_memory_heatmaps(sim, args.out)
        print(f"{n} per-layer heatmaps -> {args.out}/memory/")
    print(f"peak occupancy: {sim.peak_cells} cells "
          f"({sim.peak_rows} rows of 8) -> {args.out}/results/")


def cmd_demo(args):
    import torch

    from alpha_yolo_quant_torch.data.coco import load_image_square
    from alpha_yolo_quant_torch.eval.plots import plot_detections
    from alpha_yolo_quant_torch.eval.records import COCO_NAMES
    from alpha_yolo_quant_torch.quantize.transform import (
        build_quantized_model,
    )
    from alpha_yolo_quant_torch.runtime.interpreter import build_int_pipeline
    from alpha_yolo_quant_torch.utils.io import read_max_a

    cfg = _cfg(args)
    device = _device(args)
    graph, params = _graph_params(args, cfg)
    model = build_quantized_model(graph, params, read_max_a(args.max_a), cfg)
    fn, _ = build_int_pipeline(model, device, dfl_w_float=params["dfl"]["w"],
                               engine=args.engine)
    img = load_image_square(args.image, cfg.image_size)[None]
    det, n_det = fn(torch.as_tensor(img, device=device))
    det = det[0].cpu().numpy()[: int(n_det[0])]
    print(f"{len(det)} detections")
    for row in det[:20]:
        print(f"  {COCO_NAMES[int(row[5])]:<15} {row[4]:.3f} "
              f"[{row[0]:.1f}, {row[1]:.1f}, {row[2]:.1f}, {row[3]:.1f}]")
    if args.plot:
        plot_detections(img[0], det[:, :4],
                        [COCO_NAMES[int(c)] for c in det[:, 5]],
                        det[:, 4], args.plot)
        print(f"plot -> {args.plot}")


def cmd_info(args):
    """Model/plan summary: layers, channels, taps, scales."""
    from alpha_yolo_quant_torch.hwsim.sram import simulate
    from alpha_yolo_quant_torch.models.graph import build_yolov8_graph

    cfg = _cfg(args)
    graph = build_yolov8_graph(cfg)
    convs = graph.convs()
    n_params = sum(c.cout * c.cin * c.kernel * c.kernel + c.cout
                   for c in convs)
    print(f"{cfg.model} K={cfg.k} {cfg.image_size}x{cfg.image_size}  "
          f"{len(convs)} convs, {n_params/1e6:.2f}M params")
    print(f"{'layer':<22}{'key':<20}{'shape':<16}{'k/s/p':<8}"
          f"{'tap':<18}{'out_tap'}")
    for c in convs:
        print(f"{c.name:<22}{c.key:<20}"
              f"{f'{c.cin}->{c.cout}':<16}"
              f"{f'{c.kernel}/{c.stride}/{c.padding}':<8}"
              f"{c.tap or '':<18}{c.out_tap or ''}")
    if args.max_a:
        from alpha_yolo_quant_torch.utils.io import read_max_a

        max_a = read_max_a(args.max_a)
        print("\ncalibration (tap: a):")
        for name, v in max_a.items():
            print(f"  {name:<20} {v:.6g}")
    sim = simulate(graph, cfg.image_size)
    print(f"\nSRAM plan: peak {sim.peak_cells} cells "
          f"({sim.peak_rows} rows of 8)")


def cmd_bench(args):
    from alpha_yolo_quant_torch import bench

    bench.run(args)


def cmd_accept(args):
    """One-command accuracy acceptance: prepare -> gate 1 (fp32 mAP) ->
    calibrate -> gate 2 (int, float NMS) -> gate 3 (int full-quant,
    q_NMS) -> optional K sweep -> report table. Exit nonzero when a
    gate's mAP50-95 drop vs the fp32 baseline exceeds the budget."""

    if args.dp and "WORLD_SIZE" in os.environ:
        raise SystemExit("accept: run it in one process; its subcommands "
                         "start the ranks of --dp themselves")
    # fail before the prepare stage does its checkpoint-load work
    _check_dp(args, args.batch_size)

    def run(argv):
        # route through the real subparsers so every default/flag has
        # one source of truth
        ns = build_parser().parse_args(argv)
        return ns.fn(ns)

    base = ["--model", args.model, "--image-size", str(args.image_size)]
    datac = (["--coco-images", args.coco_images,
              "--coco-ann", args.coco_ann,
              "--batch-size", str(args.batch_size)]
             + (["--limit", str(args.limit)]
                if args.limit is not None else []))
    devc = ["--device", args.device] + (["--dp", str(args.dp)]
                                        if args.dp else [])
    evalc = datac + devc + ["--conf-thres", str(args.conf_thres)] \
        + (["--prefetch"] if args.prefetch else [])

    def out_for(k):
        # reference artifact-dir naming: 8_nano / 6_nano / 4_nano
        # (stage_0.py's per-K trees); the primary K uses --out as given
        from alpha_yolo_quant_torch.config import QuantConfig
        return args.out if k == args.k else os.path.join(
            os.path.dirname(args.out) or ".",
            QuantConfig(model=args.model, k=k).main_dir_name)

    print(f"== accept: prepare ({args.checkpoint or 'random init'}) ==")
    run(["prepare"] + base + ["--k", str(args.k), "--out", args.out]
        + (["--checkpoint", args.checkpoint] if args.checkpoint else []))
    weights = os.path.join(args.out, "results", "weights_batchnf.npz")

    print("== accept: gate 1 — fp32 BN-fused mAP ==")
    g1 = run(["eval-float"] + base
             + ["--k", str(args.k), "--out", args.out,
                "--weights", weights] + evalc)

    rows = []   # (label, res, out_dir)
    ks = [args.k] + [int(s) for s in
                     (args.k_sweep.split(",") if args.k_sweep else [])]
    for k in ks:
        out_k = out_for(k)
        kc = ["--k", str(k), "--out", out_k, "--weights", weights]
        print(f"== accept: calibrate K={k} (mode={args.mode}) ==")
        run(["calibrate"] + base + kc + ["--mode", args.mode] + datac
            + devc)
        max_a = os.path.join(out_k, "results", "max_a.txt")
        intc = (["eval-int8"] + base + kc
                + ["--max-a", max_a, "--engine", args.engine] + evalc)
        print(f"== accept: gate 2 — int{k}, float NMS ==")
        rows.append((f"int{k} float-NMS", run(intc), out_k))
        print(f"== accept: gate 3 — int{k} full-quant, q_NMS ==")
        rows.append((f"int{k} full-quant",
                     run(intc + ["--full-quant"]), out_k))

    print("\n== acceptance report ==")
    print(f"{'config':<20}{'mAP50-95':>10}{'drop':>8}  verdict")
    print(f"{'fp32 baseline':<20}{g1.map50_95:>10.4f}{0.0:>8.4f}  "
          "(gate 1)")
    failed = []
    for label, res, _ in rows:
        drop = g1.map50_95 - res.map50_95
        ok = drop <= args.drop_budget
        print(f"{label:<20}{res.map50_95:>10.4f}{drop:>8.4f}  "
              f"{'PASS' if ok else 'FAIL'} (budget {args.drop_budget})")
        if not ok:
            failed.append(label)
    if failed:
        print(f"ACCEPT: FAIL ({', '.join(failed)}) — sweep calibration "
              "modes (--mode median | min_mae | n=5) before touching "
              "the quantizer", file=sys.stderr)
        return 1
    print("ACCEPT: PASS")
    return 0


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
    sp.add_argument("--dp", type=int, default=0,
                    help="shard calibration batches over N ranks "
                         "(per-image maxima gather back, so every --mode "
                         "reduction is unchanged)")
    sp.set_defaults(fn=cmd_calibrate)

    sp = sub.add_parser("quantize", help="integer transform + full export")
    common(sp, device=False)
    sp.add_argument("--max-a", required=True)
    sp.add_argument("--full-quant", action="store_true")
    sp.add_argument("--image", help="golden image (jpg/png)")
    sp.set_defaults(fn=cmd_quantize)

    for name, fn in (("eval-float", cmd_eval_float),
                     ("eval-int8", cmd_eval_int8)):
        sp = sub.add_parser(name, help=f"COCO mAP ({name})")
        common(sp)
        sp.add_argument("--coco-images", required=True)
        sp.add_argument("--coco-ann", required=True)
        sp.add_argument("--limit", type=int, default=None)
        sp.add_argument("--batch-size", type=int, default=16)
        sp.add_argument("--conf-thres", type=float, default=0.001)
        sp.add_argument("--prefetch", action="store_true",
                        help="async host decode + device staging")
        sp.add_argument("--dp", type=int, default=0,
                        help="shard each batch over N ranks (data "
                             "parallelism; N must divide --batch-size)")
        if name == "eval-int8":
            sp.add_argument("--max-a", required=True)
            sp.add_argument("--full-quant", action="store_true")
            sp.add_argument("--engine", default="fused",
                            choices=["fused", "pallas", "packed"])
        sp.set_defaults(fn=fn)

    sp = sub.add_parser("memsim", help="SRAM allocation simulation")
    common(sp, weights=False, device=False)
    sp.add_argument("--heatmaps", action="store_true",
                    help="emit per-layer occupancy heatmaps into memory/")
    sp.add_argument("--min-buffer", action="store_true",
                    help="bisect the smallest SRAM capacity that fits "
                         "this model/size instead of simulating at the "
                         "reference capacity")
    sp.set_defaults(fn=cmd_memsim)

    sp = sub.add_parser("demo", help="single-image smoke run")
    common(sp)
    sp.add_argument("--max-a", required=True)
    sp.add_argument("--full-quant", action="store_true")
    sp.add_argument("--engine", default="fused",
                    choices=["fused", "pallas", "packed"])
    sp.add_argument("--image", required=True)
    sp.add_argument("--plot")
    sp.set_defaults(fn=cmd_demo)

    sp = sub.add_parser("info", help="model/plan summary")
    common(sp, weights=False, device=False)
    sp.add_argument("--max-a")
    sp.set_defaults(fn=cmd_info)

    sp = sub.add_parser("serve",
                        help="batch-coalescing inference over an image "
                             "list (JSONL detections out)")
    common(sp)
    sp.add_argument("--max-a")
    sp.add_argument("--from-artifacts", action="store_true",
                    help="load the quantized model from --out's exported "
                         "artifact tree (the stage-8 production load) "
                         "instead of --weights/--max-a")
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
    sp.add_argument("--dp", type=int, default=0,
                    help="shard each coalesced step over N ranks (must "
                         "divide --max-batch)")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("accept",
                        help="one-command accuracy acceptance: prepare "
                             "-> fp32 gate -> calibrate -> int gates "
                             "-> K sweep -> report")
    common(sp, weights=False)
    sp.add_argument("--checkpoint", help="torch .pt state dict "
                    "(an ultralytics yolov8{n,s,m,l,x}.pt matching "
                    "--model)")
    sp.add_argument("--coco-images", required=True)
    sp.add_argument("--coco-ann", required=True)
    sp.add_argument("--limit", type=int, default=None)
    sp.add_argument("--batch-size", type=int, default=64)
    sp.add_argument("--conf-thres", type=float, default=1e-8,
                    help="mAP protocol threshold (runbook default)")
    sp.add_argument("--prefetch", action="store_true")
    sp.add_argument("--mode", default="max",
                    help="calibration reduction (stage_5 lever)")
    sp.add_argument("--engine", default="fused",
                    choices=["fused", "pallas", "packed"])
    sp.add_argument("--k-sweep", default="",
                    help="extra bit widths, e.g. '6,4' (each gets its "
                         "own artifact dir + gates)")
    sp.add_argument("--drop-budget", type=float, default=0.5,
                    help="max allowed mAP50-95 drop vs fp32 (BASELINE)")
    sp.add_argument("--dp", type=int, default=0,
                    help="shard every gate's batches over N ranks "
                         "(forwarded to calibrate, eval-float and "
                         "eval-int8)")
    sp.set_defaults(fn=cmd_accept)

    from alpha_yolo_quant_torch import bench

    sp = sub.add_parser("bench", help="whole-pipeline throughput (one "
                                      "card, or --dp)")
    bench.add_arguments(sp)
    sp.set_defaults(fn=cmd_bench)

    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    ret = args.fn(args)
    # cmd_eval_* return an EvalResult for cmd_accept; only an int is an
    # exit code
    return ret if isinstance(ret, int) else 0


if __name__ == "__main__":
    sys.exit(main())
