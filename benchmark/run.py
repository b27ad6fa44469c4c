"""Run one cell of BENCHMARK.json once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(also ``python3 -m benchmark.run``), from the root of a checkout, on a
machine with the card(s) the cell asks for. A run:

1. makes the weights, the calibration and the image pool from the seed
   (benchmark/inputs.py) and hands them to the program's set-up
   (benchmark/program.py), then warms up the mix's shapes;
2. measures for ``--seconds`` (benchmark/loops.py); with ``--trace 1``
   it then profiles a few more batches;
3. frees the program's state and holds the window's answers for a sample
   of pool images against the plain reference the configuration names
   (benchmark/spec.reference, benchmark/check.py);
4. prints the checks on stderr and, as the last line of stdout, one JSON
   object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
   end-to-end metrics, or with ``--trace 1`` its per-layer ones),
   ``device``, with ``--trace 1`` a ``breakdown``, and ``checks`` last.

``setup_s`` runs from the start of this script to the first timed call.
A machine without the card(s) gets no result and a non-zero exit; so
does a process that holds jax or the JAX package once the window has
closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import check, counts, inputs, loops, program, spec  # noqa

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "alpha_yolo_quant_tpu"})
REF_BLOCK = 4        # images per block of the reference's convs
NAME_CHARS = 160     # an operation's name in the breakdown, cut to this


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    cell: spec.Cell
    window: loops.Window
    setup_s: float
    macs_per_image: int
    forward_bound_s: Callable[[int], float]   # batch -> summed conv bound


def ref_cfg(config: Dict, k: Optional[int] = None):
    """The configuration's reference ``QuantConfig``, at bit width ``k``
    (the file's where None)."""
    return spec.reference(config).config.QuantConfig(
        model=config["model"], k=config["k"] if k is None else k,
        full_quant=config["full_quant"], image_size=config["image_size"],
        koeff_bits=config["koeff_bits"])


def check_config(config: Dict, graph) -> None:
    """The configuration file states the shapes that run: its scale is its
    reference's for the model's name, its classes are the Cout of every
    level's ``<level>_cls`` output and 4 x its box bins that of every
    ``<level>_box``, and its convs and conv weights are those of the graph
    built from it."""
    cfg = ref_cfg(config)
    scale = config["scale"]
    convs = graph.convs()
    cout = {n.dst: n.cout for n in convs}
    stated = {"depth_multiple": (scale["depth_multiple"], cfg.depth),
              "width_multiple": (scale["width_multiple"], cfg.width),
              "max_channels": (scale["max_channels"], 512 * cfg.ratio),
              "convs": (config["convs"], len(convs)),
              "conv_weights": (config["conv_weights"], sum(
                  n.cout * n.cin * n.kernel ** 2 for n in convs))}
    per_level = {"cls": ("nc", config["nc"]),
                 "box": ("reg_max", 4 * config["reg_max"])}
    for role, e in graph.outputs.items():
        level, kind = role.rsplit("_", 1)
        key, value = per_level[kind]
        stated[f"{key}.{level}"] = (value, cout[e])
    wrong = {k: v for k, v in stated.items() if v[0] != v[1]}
    if wrong:
        raise ValueError(f"{config['name']}: stated != built {wrong}")


def reference_fn(config: Dict, params: Dict, max_a: Dict, k: int, device):
    """The plain reference as a pipeline ``fn`` at bit width ``k``: the
    control puts it in the program's place."""
    ref = spec.reference(config)
    cfg = ref_cfg(config, k)
    qm = ref.quant.quantize_model(ref.graph.build_yolov8_graph(cfg), params,
                                  max_a, cfg)

    def fn(images):
        det, n = ref.pipeline.detect(qm, np.asarray(images), config["nms"],
                                     device, REF_BLOCK)
        return torch.as_tensor(det), torch.as_tensor(n)
    return fn


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device="cuda", root: Path = spec.ROOT,
             wrap_fn: Optional[Callable] = None,
             no_warmup: bool = False) -> Dict:
    """One run of one cell. ``wrap_fn(fn, config, params, max_a)`` may
    replace the program's pipeline (the control and the fault tests);
    ``no_warmup`` skips the warm-up (the control's reference has nothing
    to warm)."""
    bench = spec.load(root)
    cell = spec.cell(bench, workload, root)
    config, traffic = cell.config, cell.traffic
    if no_warmup:
        traffic = dict(traffic, warmup_batches=0)
    size = config["image_size"]
    ref = spec.reference(config)
    graph = ref.graph.build_yolov8_graph(ref_cfg(config))
    check_config(config, graph)
    seeds = inputs.Seeds(seed)
    params = inputs.make_params(graph, seeds, device)
    max_a = inputs.make_max_a(ref, graph, params, seeds,
                              config["calibration_images"], size, device)
    n_pool = traffic["batch"] * traffic["pool_batches"]
    pool = inputs.make_pool(seeds, n_pool, size, device)
    checked = loops.sample(seeds, n_pool, traffic["check_images"])
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    fn = program.build(config, params, max_a, device)
    if wrap_fn is not None:
        fn = wrap_fn(fn, config, params, max_a)
    w = loops.closed(fn, traffic, pool, checked, seconds, trace, device)
    del fn
    gc.collect()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    qm = ref.quant.quantize_model(graph, params, max_a, ref_cfg(config))
    det, n = ref.pipeline.detect(qm, pool[checked], config["nms"], device,
                                 REF_BLOCK)
    checks = check.compare(w.answers, {i: (det[j], n[j])
                                       for j, i in enumerate(checked)})
    ref_s = time.perf_counter() - t_ref

    shapes = ref.graph.edge_shapes(graph, size)
    run = Run(cell, w, w.setup_end - T_START,
              counts.image_macs(graph, shapes),
              lambda b: counts.forward_bound_s(graph, shapes, qm.edge_amax,
                                               b))
    metrics = {}
    for m in spec.metrics(bench, workload, trace):
        v = spec.reader(m["name"], root)(run)
        if v is not None and np.isfinite(v):
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": w.peak_bytes}
    result = {"correct": check.passed(checks), "attempted": w.images,
              "failed": 0, "metrics": metrics, "device": dev}
    if trace and w.trace is not None:
        dev["busy_s"] = w.trace.busy_s
        dev["window_s"] = w.trace.span_s
        result["breakdown"] = {
            "device_ops": [[k[:NAME_CHARS], v] for k, v in
                           w.trace.top(w.trace.device_s_by_name)],
            "idle_gaps": [[k[:NAME_CHARS], v] for k, v in
                          w.trace.top(w.trace.idle_by_host_op)]}
    result["checks"] = checks
    notes = [f"window {w.seconds:.3f} s, {w.images} images answered; "
             f"reference "
             f"{ref_s:.1f} s over {len(checked)} pool images"]
    return {"result": result, "notes": notes + window_notes(w)}


def window_notes(w: loops.Window) -> List[str]:
    """What explains a run's numbers, for its stderr: the spread of its
    batch times, the profiled H2D copies, garbage collections inside the
    window."""
    notes = []
    if w.step_s:
        st = np.asarray(w.step_s) * 1e3
        notes.append("batch ms: " + ", ".join(
            f"p{q} {np.percentile(st, q):.2f}" for q in (0, 10, 50, 90, 100)))
    if w.trace is not None:
        h2d = sum(v for k, v in w.trace.device_s_by_name.items()
                  if "HtoD" in k)
        notes.append(f"profiled: {w.steps_profiled} steps, H2D copies "
                     f"{1e3 * h2d / max(w.steps_profiled, 1):.2f} ms a step")
    if w.gc_pauses:
        ms = [1e3 * t for _, t in w.gc_pauses]
        notes.append(f"gc in the window: {len(ms)} collections "
                     f"({sum(g == 2 for g, _ in w.gc_pauses)} of "
                     f"generation 2), {sum(ms):.1f} ms, longest "
                     f"{max(ms):.1f} ms")
    return notes


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(0)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load()
    chips = spec.cell(bench, args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    cache = ROOT / "benchmark" / ".cache"
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {bad}", file=sys.stderr)
        return 3
    print(f"card: {card()}", file=sys.stderr)
    for line in out["notes"] + check.lines(out["result"]["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
