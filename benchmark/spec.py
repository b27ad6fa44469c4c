"""BENCHMARK.json and the files it names, found by name.

- a cell is an entry of ``workloads``: its ``config`` names an entry of
  ``configs``, whose ``file`` holds the configuration;
- a traffic mix is ``benchmark/traffic/<traffic>.json``, the parameters
  the general generator (inputs.py, loops.py) reads;
- a metric is ``benchmark/metrics/<name>.py``, a reader with
  ``read(run) -> float | None`` (None: nothing to read in this run).

Adding a configuration, a mix or a metric takes new files and entries
only.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parent.parent


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
