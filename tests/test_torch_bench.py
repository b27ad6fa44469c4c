"""The port's profiling utilities (utils/profiling.py) and its bench
(alpha_yolo_quant_torch/bench.py, the CLI's bench) on the CPU: the trace
written, the MAC count equal to JAX's shape walk, the bench's JSON lines
named as bench.py names them and labelled as CPU numbers, and no run on a
CUDA device without a card (the spans: test_torch_tracing.py)."""

import json
import os

import pytest

import conftest  # noqa: F401

import torch

from alpha_yolo_quant_tpu.config import QuantConfig as JConfig
from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph as jbuild
from alpha_yolo_quant_tpu.parallel.pipeline import _node_costs
from alpha_yolo_quant_torch import bench
from alpha_yolo_quant_torch import cli as tcli
from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.models.graph import build_yolov8_graph, node_costs
from alpha_yolo_quant_torch.utils import profiling as tprof
from test_torch_model_build import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_device_trace_none_is_a_no_op_and_dir_gets_a_trace(tmp_path):
    with tprof.device_trace(None) as path:
        torch.ones(4).sum()
    assert path is None
    out = tmp_path / "trace"
    with tprof.device_trace(str(out)) as path:
        (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    assert os.path.dirname(path) == str(out) and os.path.isfile(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_bench_fn_on_the_cpu():
    calls = []
    ms = tprof.bench_fn(lambda a: calls.append(a) or torch.ones(256).sum(),
                        7, iters=3, warmup=1, device="cpu")
    assert ms > 0 and calls == [7] * 4


@pytest.mark.parametrize("model", ["yolov8n", "yolov8s", "yolov8m"])
def test_mac_walk_equals_jax(model):
    got = node_costs(build_yolov8_graph(QuantConfig(model=model)), 640)
    want = _node_costs(jbuild(JConfig(model=model)), 640)
    assert got == want and sum(got) > 4e9


def _json_line(out):
    return json.loads(out.strip().splitlines()[-1])


def test_bench_lines_on_the_cpu(capsys):
    """bench.py's metric names; the device is "cpu" and no mfu (a share
    of the card's peak) is given for a CPU run."""
    common = dict(image_size=64, batch=2, iters=2, device="cpu")
    got = bench.main(**common)
    cap = capsys.readouterr()
    assert _json_line(cap.out) == got
    assert got["metric"] == "yolov8n_64_int8_e2e"
    assert (got["unit"], got["device"], got["mfu"]) == ("img/s", "cpu", None)
    assert got["value"] > 0
    assert cap.err.startswith("bench: cpu engine fused: ")
    got = bench.main(input_dtype="u8", engine="packed", **common)
    assert got["metric"] == "yolov8n_64_int8_e2e_u8"
    assert _json_line(capsys.readouterr().out)["device"] == "cpu"


def test_cli_bench_coalesced_on_the_cpu(capsys):
    assert tcli.main(["bench", "--device", "cpu", "--image-size", "64",
                      "--batch", "2", "--iters", "2", "--coalesce", "2",
                      "--engine", "pallas"]) == 0
    line = _json_line(capsys.readouterr().out)
    assert line["metric"] == "yolov8n_64_int8_e2e_co2x2"
    assert line["device"] == "cpu" and line["value"] > 0


def test_no_card_stops_instead_of_running_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        bench.main(image_size=64, batch=2)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["bench", "--image-size", "64"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tprof.bench_fn(lambda: None)
    assert tcli.build_parser().parse_args(["bench"]).device == "cuda"


def test_card_name_reads_nvidia_smi_else_torch(monkeypatch):
    import subprocess
    import types

    def smi(argv, **kw):
        assert argv[1:] == ["--query-gpu=name,power.limit",
                            "--format=csv,noheader"]
        return types.SimpleNamespace(
            stdout="NVIDIA H100 80GB HBM3, 700.00 W\n")

    monkeypatch.setattr(subprocess, "run", smi)
    assert tprof.card_name() == "NVIDIA H100 80GB HBM3, 700.00 W"

    def absent(argv, **kw):
        raise FileNotFoundError(argv[0])

    monkeypatch.setattr(subprocess, "run", absent)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: f"card {d}")
    assert tprof.card_name("cuda:0") == "card cuda:0"
