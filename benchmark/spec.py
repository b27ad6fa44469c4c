"""BENCHMARK.json and the files it names, found by name.

- a cell is an entry of ``workloads``: its ``config`` names an entry of
  ``configs``, whose ``file`` holds the configuration;
- a traffic mix is ``benchmark/traffic/<traffic>.json``, the parameters
  the general generator (inputs.py, loops.py) reads;
- a metric is ``benchmark/metrics/<name>.py``, a reader with
  ``read(run) -> float | None`` (None: nothing to read in this run);
- a configuration's plain reference is the package ``benchmark/<name>/``
  that its file's ``"reference"`` key names (``reference`` where the key
  is absent), loaded by ``reference(config)``.

Adding a configuration, its reference, a mix or a metric takes new files
and entries only.

A reference package is plain PyTorch and NumPy that imports nothing of
the program or of JAX, and has these modules (a module may import what it
shares from another reference package, such as ``benchmark.reference``):

- ``config.QuantConfig(model=, k=, full_quant=, image_size=,
  koeff_bits=)``, with the scale's ``depth``, ``width`` and ``ratio``
  (the channel cap is ``512 * ratio``);
- ``graph.build_yolov8_graph(cfg) -> graph`` and
  ``graph.edge_shapes(graph, image_size) -> {edge: (C, H, W)}`` of one
  image. The harness reads of a graph ``convs()``, each conv's ``name``,
  ``key``, ``src``, ``dst``, ``cin``, ``cout``, ``kernel`` and ``silu``,
  and ``outputs``: role -> edge, one ``<level>_cls`` and one
  ``<level>_box`` role for each detect level, whatever the levels;
- ``forward.calibration_taps(graph, params, images) -> {tap: max-abs}``,
  the float32 calibration forward;
- ``quant.quantize_model(graph, params, max_a, cfg) -> model``, the
  integer model, whose ``edge_amax`` (edge -> integer magnitude bound)
  sets each conv input's byte width in benchmark/counts.py;
- ``pipeline.detect(model, images, nms, device, block) -> (det, n_det)``:
  uint8 NCHW images to the detections the program's ``fn`` gives.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
import types
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent
DEFAULT_REFERENCE = "reference"
REFERENCE_MODULES = ("config", "graph", "forward", "quant", "pipeline")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: Dict      # the configuration file, plus its entry's "name"
    traffic: Dict     # the traffic file, plus "name"


def load(root: Path = ROOT) -> Dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries: List[Dict], name: str, what: str) -> Dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: Dict, name: str, root: Path = ROOT) -> Cell:
    w = _by_name(bench["workloads"], name, "workload")
    c = _by_name(bench["configs"], w["config"], "config")
    with open(Path(root) / c["file"]) as f:
        config = dict(json.load(f), name=c["name"])
    with open(Path(root) / "benchmark" / "traffic"
              / f"{w['traffic']}.json") as f:
        traffic = dict(json.load(f), name=w["traffic"])
    return Cell(name, int(w["chips"]), config, traffic)


def reports(entry: Dict, cell_name: str) -> bool:
    return "workloads" not in entry or cell_name in entry["workloads"]


def metrics(bench: Dict, cell_name: str, trace: bool) -> List[Dict]:
    """The cell's end-to-end metrics (trace off) or per-layer metrics
    (trace on). A per-layer metric without ``workloads`` is reported in
    every cell that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"] if reports(m, cell_name)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if ("workloads" in m and cell_name in m["workloads"])
            or ("workloads" not in m and m["moves"] in names)]


def reader(name: str, root: Path = ROOT):
    """The ``read`` function of ``benchmark/metrics/<name>.py``."""
    path = Path(root) / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def reference(config: Dict) -> types.SimpleNamespace:
    """The modules of the plain reference the configuration names, by
    their names in ``REFERENCE_MODULES``."""
    name = config.get("reference", DEFAULT_REFERENCE)
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"reference {name!r} is not a package name")
    return types.SimpleNamespace(**{
        m: importlib.import_module(f"benchmark.{name}.{m}")
        for m in REFERENCE_MODULES})
