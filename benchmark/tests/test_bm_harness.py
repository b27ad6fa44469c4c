"""The harness on the CPU at 64 px: runs of each cell come out correct,
broken pipelines and the control come out not correct, files added by
name are found (a configuration's own reference among them), the inputs
are a function of the seed, and nothing loads JAX."""

import ast
import dataclasses
import importlib
import json
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import benchmark
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


def test_every_level_must_state_the_classes():
    """A graph whose detect levels disagree on the classes is refused,
    whichever level it is."""
    config = spec.cell(spec.load(), CELLS[0]).config
    ref = spec.reference(config)
    graph = ref.graph.build_yolov8_graph(run.ref_cfg(config))
    run.check_config(config, graph)
    p4_cls = graph.outputs["p4_cls"]
    nodes = tuple(dataclasses.replace(n, cout=n.cout - 1)
                  if getattr(n, "dst", None) == p4_cls else n
                  for n in graph.nodes)
    bad = dataclasses.replace(graph, nodes=nodes)
    with pytest.raises(ValueError, match="nc.p4") as e:
        run.check_config(dict(config, conv_weights=sum(
            n.cout * n.cin * n.kernel ** 2 for n in bad.convs())), bad)
    assert "nc.p3" not in str(e.value) and "nc.p5" not in str(e.value)


@pytest.fixture
def copied_reference(tmp_path):
    """Copies of benchmark/reference under other package names, in a
    directory added to the ``benchmark`` package's path, never the
    checkout: ``copy(name, edit)`` makes ``benchmark.<name>``, with
    ``edit(module, text) -> text`` applied to each module's source."""
    pkgs = tmp_path / "packages"
    pkgs.mkdir()
    made = []

    def copy(name, edit=lambda module, text: text):
        dst = pkgs / name
        shutil.copytree(ROOT / "benchmark" / "reference", dst,
                        ignore=shutil.ignore_patterns("__pycache__"))
        for p in dst.glob("*.py"):
            text = p.read_text().replace("benchmark.reference.",
                                         f"benchmark.{name}.")
            p.write_text(edit(p.stem, text))
        made.append(name)
        importlib.invalidate_caches()
        return name

    benchmark.__path__.append(str(pkgs))
    try:
        yield copy
    finally:
        benchmark.__path__.remove(str(pkgs))
        for m in [m for m in sys.modules if m.split(".")[:2] in
                  (["benchmark", n] for n in made)]:
            del sys.modules[m]


def _name_reference(root, cell, name):
    """Point the configuration of ``cell`` in the tree at ``root`` to the
    reference package ``name``."""
    bench = spec.load(root)
    entry = next(c for c in bench["configs"] if c["name"] == next(
        w["config"] for w in bench["workloads"] if w["name"] == cell))
    p = root / entry["file"]
    p.write_text(json.dumps(dict(json.loads(p.read_text()), reference=name)))


def _stride_p3(module, text):
    """The reference's first detect level at stride 9 instead of 8."""
    if module != "pipeline":
        return text
    assert "STRIDES = (8, 16, 32)" in text
    return text.replace("STRIDES = (8, 16, 32)", "STRIDES = (9, 16, 32)")


@pytest.mark.parametrize("cell", CELLS)
def test_a_configuration_runs_the_reference_it_names(tiny_root, one_thread,
                                                     copied_reference, cell):
    """A configuration that names its own copy of the reference runs
    through run.py, control.py, inputs and counts with no other file
    changed: it comes out correct, and the control run through it does
    not; a copy with one constant of its head altered comes out not
    correct, so the named copy is the one that judges."""
    _name_reference(tiny_root, cell, copied_reference("reference_copy"))
    out = run.run_cell(cell, SEED, 0.3, True, "cpu", tiny_root)["result"]
    assert out["correct"], out["checks"]
    assert sys.modules["benchmark.reference_copy.pipeline"]
    assert out["metrics"]["mfu.offline"]["value"] > 0
    ctl = control.control_run(cell, SEED, 0.3, "cpu", tiny_root)
    assert not ctl["correct"]
    assert ctl["checks"]["answers_wrong"]["value"] > 0
    _name_reference(tiny_root, cell,
                    copied_reference("reference_altered", _stride_p3))
    out = run.run_cell(cell, SEED, 0.3, False, "cpu", tiny_root)["result"]
    assert not out["correct"]
    assert out["checks"]["answers_wrong"]["value"] > 0


def test_a_reference_name_is_a_package_name():
    with pytest.raises(ValueError, match="package name"):
        spec.reference({"reference": "../reference"})


def _reference_packages():
    """The reference packages under benchmark/: the default, each one a
    configuration names, and each that spec.reference can load."""
    named = {spec.DEFAULT_REFERENCE} | {
        json.loads((ROOT / c["file"]).read_text()).get(
            "reference", spec.DEFAULT_REFERENCE)
        for c in spec.load()["configs"]}
    loadable = {d.name for d in (ROOT / "benchmark").iterdir()
                if all((d / f"{m}.py").is_file()
                       for m in spec.REFERENCE_MODULES)}
    return named | loadable


def test_no_harness_module_imports_the_reference():
    """The harness reaches a cell's reference only through
    spec.reference: no module of it imports benchmark.reference. A
    reference package is no harness module and may reuse another's."""
    skip = _reference_packages() | {"tests", ".cache"}
    files = [p for p in (ROOT / "benchmark").rglob("*.py")
             if p.relative_to(ROOT / "benchmark").parts[0] not in skip]
    assert len(files) > 10
    for p in files:
        for n in _imports(p):
            assert not n.startswith("benchmark.reference"), (p, n)


def _imports(path):
    """Every module name an import statement of ``path`` may load."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""
            yield from (f"{node.module}.{a.name}" for a in node.names)


def test_inputs_are_a_function_of_the_seed():
    pools = [inputs.make_pool(inputs.Seeds(s), 3, 32, "cpu")
             for s in (SEED, SEED, SEED + 1)]
    assert np.array_equal(pools[0], pools[1])
    assert not np.array_equal(pools[0], pools[2])
    samples = [loops.sample(inputs.Seeds(s), 512, 16)
               for s in (SEED, SEED, SEED + 1)]
    assert samples[0] == samples[1] != samples[2]
    ref = spec.reference({})
    graph = ref.graph.build_yolov8_graph(ref.config.QuantConfig(
        image_size=64))
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
    """Neither benchmark/reference nor any package a configuration names
    imports the program or JAX, by its sources or when loaded."""
    banned = run.FORBIDDEN | {"alpha_yolo_quant_torch"}
    for name in sorted(_reference_packages()):
        for p in (ROOT / "benchmark" / name).glob("*.py"):
            for n in _imports(p):
                assert n.split(".")[0] not in banned, (p, n)
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
                "from benchmark import spec\n"
                f"spec.reference({{'reference': {name!r}}})\n"
                "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=120,
                             check=True)
        loaded = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
        assert not loaded & banned, name


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
