"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark's
data files (BENCHMARK.json, configs, traffic, metrics) cut to a size the
CPU runs in a second, found by name like the real ones."""

import json
import shutil
from pathlib import Path

import pytest
import torch

from benchmark.spec import ROOT

TINY_CONFIG = {"image_size": 64}
TINY_TRAFFIC = {
    "offline-u8-b128": {"batch": 8, "pool_batches": 2, "warmup_batches": 1,
                        "trace_steps": 2, "check_images": 16},
}


def copy_tree(dst: Path) -> Path:
    """BENCHMARK.json and the benchmark's data files under ``dst``, every
    configuration at 64 px and every mix shrunk; returns ``dst``."""
    (dst / "benchmark").mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    for d in ("configs", "traffic", "metrics"):
        shutil.copytree(ROOT / "benchmark" / d, dst / "benchmark" / d)
    for p in (dst / "benchmark" / "configs").glob("*.json"):
        p.write_text(json.dumps(dict(json.loads(p.read_text()),
                                     **TINY_CONFIG)))
    for name, over in TINY_TRAFFIC.items():
        p = dst / "benchmark" / "traffic" / f"{name}.json"
        p.write_text(json.dumps(dict(json.loads(p.read_text()), **over)))
    return dst


@pytest.fixture
def tiny_root(tmp_path):
    return copy_tree(tmp_path / "tree")


@pytest.fixture
def one_thread():
    """One torch thread: test files may run in parallel xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)
