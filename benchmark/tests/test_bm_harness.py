"""The harness on the CPU at 64 px: runs of each cell come out correct,
broken pipelines and the control come out not correct, files added by
name are found, the inputs are a function of the seed, and nothing loads
JAX."""

import ast
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import control, inputs, loops, run, spec
from benchmark.spec import ROOT

CELLS = ("yolov8n-offline-u8", "yolov8m-offline-u8")
SEED = 2 ** 31 + 7


@pytest.mark.parametrize("cell", CELLS)
def test_cpu_run_is_correct(tiny_root, one_thread, cell):
    out = run.run_cell(cell, SEED, 0.3, False, "cpu", tiny_root)["result"]
    assert out["correct"], out["checks"]
    assert out["checks"]["answers_compared"]["value"] > 0
    assert out["failed"] == 0 and out["attempted"] > 0
    names = {m["name"] for m in spec.metrics(spec.load(tiny_root), cell,
                                             False)}
    # peak_mem_gib reads the card's allocator: nothing to read on the CPU
    assert set(out["metrics"]) == names - {"peak_mem_gib"}
    assert list(out)[-1] == "checks"


def test_traced_run_reads_its_per_layer_metrics(tiny_root, one_thread):
    out = run.run_cell(CELLS[0], SEED, 0.3, True, "cpu", tiny_root)["result"]
    assert out["correct"]
    # the CPU has no device trace: only the host-clock metric reads
    assert set(out["metrics"]) == {"mfu.offline"}
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _half_batch(fn, *_):
    def broken(x):
        return tuple(t[:len(x) // 2] for t in fn(x))
    return broken


def _altered(fn, *_):
    def broken(x):
        det, n = fn(x)
        det = det.clone()
        det[:, 0, 0] += 1
        return det, n
    return broken


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", (_half_batch, _altered))
def test_broken_timed_path_is_not_correct(tiny_root, one_thread, cell,
                                          fault):
    out = run.run_cell(cell, SEED, 0.3, False, "cpu", tiny_root,
                       wrap_fn=fault)["result"]
    assert not out["correct"]
    c = out["checks"]
    assert c["answers_wrong"]["value"] + c["answers_missing"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_lower_precision_is_not_correct(tiny_root, one_thread,
                                                   cell):
    out = control.control_run(cell, SEED, 0.3, "cpu", tiny_root)
    assert not out["correct"]
    assert out["checks"]["answers_wrong"]["value"] > 0


def test_files_added_by_name_are_found(tiny_root, one_thread):
    """A configuration, a mix and a metric added as files, with entries in
    BENCHMARK.json, run without an edit to any file already there."""
    b = tiny_root / "benchmark"
    cfg = json.loads((b / "configs" / "yolov8n-int8-640.json").read_text())
    (b / "configs" / "yolov8s-int8-64.json").write_text(json.dumps(dict(
        cfg, model="yolov8s", convs=63, conv_weights=11146080,
        scale={"depth_multiple": 0.33, "width_multiple": 0.5,
               "max_channels": 1024})))
    mix = json.loads((b / "traffic" / "offline-u8-b128.json").read_text())
    (b / "traffic" / "offline-u8-b4.json").write_text(
        json.dumps(dict(mix, batch=4)))
    (b / "metrics" / "batches.offline.py").write_text(
        "def read(run):\n    return run.window.images / run.window.batch\n")
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "yolov8s-int8-64", "source": "s",
                             "file": "benchmark/configs/yolov8s-int8-64.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "yolov8s-offline-u8-b4",
                               "config": "yolov8s-int8-64",
                               "traffic": "offline-u8-b4", "chips": 1,
                               "why": "test"})
    bench["end_to_end"][0]["workloads"].append("yolov8s-offline-u8-b4")
    bench["per_layer"].append({"name": "batches.offline", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "throughput",
                               "workloads": ["yolov8s-offline-u8-b4"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run.run_cell("yolov8s-offline-u8-b4", SEED, 0.3, True, "cpu",
                       tiny_root)["result"]
    assert out["correct"]
    assert out["metrics"]["batches.offline"]["value"] == out["attempted"] / 4


@pytest.mark.parametrize("key,value,named", (
    ("scale", {"depth_multiple": 0.33, "width_multiple": 0.5,
               "max_channels": 1024}, "width_multiple"),
    ("nc", 20, "nc"), ("reg_max", 8, "reg_max"), ("convs", 62, "convs"),
    ("conv_weights", 1, "conv_weights")))
def test_configuration_must_state_the_shapes_that_run(tiny_root, key,
                                                      value, named):
    """A configuration file whose stated scale, classes, box bins, convs
    or conv weights are not those of the graph built from its model's
    name is refused before anything runs."""
    p = tiny_root / "benchmark" / "configs" / "yolov8n-int8-640.json"
    p.write_text(json.dumps(dict(json.loads(p.read_text()), **{key: value})))
    with pytest.raises(ValueError, match=named):
        run.run_cell("yolov8n-offline-u8", SEED, 0.3, False, "cpu",
                     tiny_root)


def test_inputs_are_a_function_of_the_seed():
    pools = [inputs.make_pool(inputs.Seeds(s), 3, 32, "cpu")
             for s in (SEED, SEED, SEED + 1)]
    assert np.array_equal(pools[0], pools[1])
    assert not np.array_equal(pools[0], pools[2])
    samples = [loops.sample(inputs.Seeds(s), 512, 16)
               for s in (SEED, SEED, SEED + 1)]
    assert samples[0] == samples[1] != samples[2]
    graph = run.ref_graph.build_yolov8_graph(
        run.ref_config.QuantConfig(image_size=64))
    p1, p2, p3 = (inputs.make_params(graph, inputs.Seeds(s), "cpu")
                  for s in (SEED, SEED, SEED + 1))
    assert all(np.array_equal(p1[k]["w"], p2[k]["w"]) for k in p1)
    assert not np.array_equal(p1["conv0.0"]["w"], p3["conv0.0"]["w"])


def test_no_jax_after_each_cell(tiny_root):
    """A tiny traced run of each cell in a fresh process leaves no module
    whose top-level name is jax, jaxlib, flax or alpha_yolo_quant_tpu."""
    code = (
        "import sys, torch; torch.set_num_threads(1)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from benchmark import run\n"
        f"root = Path({str(tiny_root)!r})\n"
        f"for cell in {CELLS!r}:\n"
        "    assert run.run_cell(cell, 3, 0.2, True, 'cpu', root)"
        "['result']['correct']\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & run.FORBIDDEN
    assert "alpha_yolo_quant_torch" in loaded


def test_reference_imports_nothing_of_the_program():
    ref = ROOT / "benchmark" / "reference"
    for p in ref.glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in (
                    run.FORBIDDEN | {"alpha_yolo_quant_torch"}), (p, n)
    code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
            "import benchmark.reference.pipeline, benchmark.reference.forward"
            "\nprint(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (run.FORBIDDEN | {"alpha_yolo_quant_torch"})


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds",
                     "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.gpu
def test_card_run_is_correct_and_needs_the_program(tmp_path):
    """On the card: a short run of the yolov8n offline cell is correct,
    and a tree of BENCHMARK.json and benchmark/ alone gives no result."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cmd = [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
           "--seed", "11", "--seconds", "2", "--trace", "0"]
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
    bare = tmp_path / "bare"
    (bare / "benchmark").mkdir(parents=True)
    (bare / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json")
                                         .read_text())
    for p in (ROOT / "benchmark").rglob("*"):
        if p.is_file() and ".cache" not in p.parts \
                and "__pycache__" not in p.parts:
            q = bare / p.relative_to(ROOT)
            q.parent.mkdir(parents=True, exist_ok=True)
            q.write_bytes(p.read_bytes())
    out = subprocess.run(cmd, cwd=bare, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode != 0
    assert not out.stdout.strip()
