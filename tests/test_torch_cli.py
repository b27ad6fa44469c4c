"""The port's CLI (python -m alpha_yolo_quant_torch.cli) end to end on the
CPU at 64 px against the JAX package's CLI: prepare from the same
synthetic torch checkpoint gives equal fused arrays, calibrate gives the
same max_a within float rounding, and serve over the same PNG list with
JAX's max_a.txt writes the same JSONL, byte for byte."""

import json
import os

import numpy as np
import pytest

import conftest  # noqa: F401

import torch

from alpha_yolo_quant_tpu import cli as jcli
from alpha_yolo_quant_tpu.utils.io import read_max_a
from alpha_yolo_quant_tpu.utils.params_io import load_params
from alpha_yolo_quant_torch import cli as tcli
from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.models.graph import build_yolov8_graph
from alpha_yolo_quant_torch.models.params import init_raw_params
from test_torch_checkpoint_io import synthetic_checkpoint
from test_torch_model_build import assert_same

SIZE = "64"


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """Both CLIs' prepare and calibrate from one synthetic checkpoint:
    {"t": port out dir, "j": JAX out dir, "tmp": scratch dir}."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    graph = build_yolov8_graph(QuantConfig(image_size=64))
    ckpt = tmp / "synthetic_yolov8n.pt"
    synthetic_checkpoint(graph, init_raw_params(graph, seed=7), ckpt)
    dirs = {"t": str(tmp / "t" / "8_nano"), "j": str(tmp / "j" / "8_nano"),
            "tmp": tmp}
    for name, cli in (("t", tcli), ("j", jcli)):
        assert cli.main(["prepare", "--out", dirs[name], "--image-size",
                         SIZE, "--checkpoint", str(ckpt)]) == 0
    calib = ["calibrate", "--image-size", SIZE, "--batch-size", "2",
             "--limit", "4"]
    assert jcli.main(calib + ["--out", dirs["j"], "--weights",
                              _npz(dirs["j"])]) == 0
    assert tcli.main(calib + ["--out", dirs["t"], "--weights",
                              _npz(dirs["t"]), "--device", "cpu"]) == 0
    return dirs


def _npz(out):
    return os.path.join(out, "results", "weights_batchnf.npz")


def _max_a(out):
    return os.path.join(out, "results", "max_a.txt")


def test_prepare_equals_jax(art):
    fused = load_params(_npz(art["t"]))
    assert_same(fused, load_params(_npz(art["j"])), "fused npz")
    assert len(fused) == 64 and fused["dfl"]["w"].shape == (1, 16, 1, 1)


def test_calibrate_equals_jax_within_float_rounding(art):
    """Float convs are not bit-identical across frameworks: rtol 1e-5 on
    every tap; the files' lines come in the same order."""
    got, want = read_max_a(_max_a(art["t"])), read_max_a(_max_a(art["j"]))
    assert list(got) == list(want) and len(got) == 64
    for tap in want:
        np.testing.assert_allclose(got[tap], want[tap], rtol=1e-5,
                                   err_msg=tap)
    with open(os.path.join(art["t"], "results", "max_a_all.txt")) as f:
        assert len(f.readlines()) == 64


def test_serve_jsonl_equals_jax(art, capsys):
    """Full quant, JAX's weights and max_a: the same JSONL bytes, one
    failed path included (exit code 1 on both)."""
    from PIL import Image

    tmp = art["tmp"]
    rng = np.random.default_rng(12)
    paths = []
    for i, (h, w) in enumerate([(80, 96), (64, 64), (50, 120), (97, 61),
                                (70, 70)]):
        p = tmp / f"img{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(str(p))
    paths.insert(2, str(tmp / "missing.png"))
    listing = tmp / "list.txt"
    listing.write_text("\n".join(paths) + "\n")
    common = ["serve", "--image-size", SIZE, "--weights", _npz(art["j"]),
              "--max-a", _max_a(art["j"]), "--full-quant",
              "--input-list", str(listing), "--max-batch", "4"]
    out_j, out_t = str(tmp / "j.jsonl"), str(tmp / "t.jsonl")
    assert jcli.main(common + ["--out", art["j"], "--engine", "xla",
                               "--output", out_j]) == 1
    capsys.readouterr()
    assert tcli.main(common + ["--out", art["t"], "--device", "cpu",
                               "--output", out_t]) == 1
    summary = capsys.readouterr().err.strip().splitlines()[-1]
    assert summary.startswith(f"served 5/6 images -> {out_t} | ")
    assert summary.endswith("| 1 FAILED")
    with open(out_t, "rb") as f:
        got = f.read()
    with open(out_j, "rb") as f:
        assert got == f.read()
    lines = [json.loads(ln) for ln in got.decode().splitlines()]
    assert [ln["path"] for ln in lines] == paths
    assert "error" in lines[2] and sum(ln.get("n", 0) for ln in lines) > 0


def test_min_mae_calibration_resumes(art, capsys):
    out = str(art["tmp"] / "min_mae")
    argv = ["calibrate", "--out", out, "--weights", _npz(art["t"]),
            "--image-size", SIZE, "--batch-size", "2", "--limit", "2",
            "--mode", "min_mae", "--device", "cpu"]
    assert tcli.main(argv) == 0
    first = read_max_a(_max_a(out))
    assert "activation dumps ->" in capsys.readouterr().out
    assert os.path.isdir(os.path.join(out, "batches", "conv_p2"))
    assert not os.path.isdir(os.path.join(out, "batches", "conv_p1"))
    assert tcli.main(argv) == 0
    assert "resumed activation dumps" in capsys.readouterr().out
    assert read_max_a(_max_a(out)) == first


def test_cuda_default_refuses_a_machine_without_a_card(art, monkeypatch):
    """--device defaults to cuda; with no card the command stops instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["calibrate", "--out", str(art["tmp"] / "x")],
                 ["serve", "--max-a", _max_a(art["j"]), "--input-list",
                  "-"]):
        with pytest.raises(SystemExit, match="no CUDA device"):
            tcli.main(argv + ["--image-size", SIZE])
    assert tcli.build_parser().parse_args(
        ["serve", "--max-a", "m", "--input-list", "-"]).engine == "fused"
