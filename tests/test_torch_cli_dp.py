"""The port's CLI under --dp (gloo ranks on the CPU, spawned by the CLI)
against its own --dp 0 run and, for eval-int8 and calibrate, the JAX CLI's
--dp 2 (JAX's 8-device virtual CPU mesh), at 64 px over four synthetic
COCO images, from JAX's prepare and calibrate:

- eval-int8 --full-quant: the det/ann CSVs byte-equal;
- calibrate: the same max_a taps in the same order, within rtol 1e-6 of
  --dp 0 (the CPU's float convs round differently at another batch size,
  as JAX's own test_cli.py allows) and 1e-5 of JAX's (the float forward
  tolerance of test_torch_cli.py);
- serve: the JSONL byte-equal to --dp 0's, one missing image included
  (test_torch_cli.py holds --dp 0's equal to the JAX CLI's);
- accept forwards --dp to calibrate, eval-float and eval-int8;
- bench: aggregate img/s named _dp2 (dp 1 keeps the base name), device
  "cpu", mfu null;
- the flag's errors read as JAX's.
"""

import json
import os

import numpy as np
import pytest

import conftest  # noqa: F401

from alpha_yolo_quant_tpu import cli as jcli
from alpha_yolo_quant_tpu.utils.io import read_max_a
from alpha_yolo_quant_torch import bench
from alpha_yolo_quant_torch import cli as tcli
from test_torch_model_build import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIZE = ["--image-size", "64"]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """JAX's prepare + calibrate, four synthetic COCO images and a serve
    list of their files plus one missing path."""
    from tests_synth import write_synthetic_coco

    tmp = tmp_path_factory.mktemp("cli_dp")
    base = str(tmp / "base" / "8_nano")
    assert jcli.main(["prepare", "--out", base] + SIZE) == 0
    weights = os.path.join(base, "results", "weights_batchnf.npz")
    assert jcli.main(["calibrate", "--out", base, "--weights", weights,
                      "--batch-size", "2", "--limit", "4"] + SIZE) == 0
    img_dir, ann = write_synthetic_coco(tmp, n_images=4)
    listing = tmp / "list.txt"
    paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
    listing.write_text("\n".join(paths[:2] + [str(tmp / "missing.png")]
                                 + paths[2:]) + "\n")
    return {"tmp": tmp, "weights": weights, "img_dir": img_dir, "ann": ann,
            "max_a": os.path.join(base, "results", "max_a.txt"),
            "list": str(listing)}


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_eval_int8_csvs_equal_dp0_and_jax(art):
    outs = {}
    for name, cli, extra in (("t2", tcli, CPU + ["--dp", "2"]),
                             ("t0", tcli, CPU),
                             ("j2", jcli, ["--engine", "xla", "--dp", "2"])):
        outs[name] = str(art["tmp"] / f"eval_{name}")
        assert cli.main(["eval-int8", "--out", outs[name], "--weights",
                         art["weights"], "--max-a", art["max_a"],
                         "--coco-images", art["img_dir"], "--coco-ann",
                         art["ann"], "--batch-size", "2", "--full-quant"]
                        + SIZE + extra) == 0
    for f in ("ann_QUANT_8_channel.csv", "det_QUANT_8_channel.csv"):
        got = _read(os.path.join(outs["t2"], "results", f))
        assert got == _read(os.path.join(outs["t0"], "results", f)), f
        assert got == _read(os.path.join(outs["j2"], "results", f)), f
    assert len(_read(os.path.join(outs["t2"], "results",
                                  "det_QUANT_8_channel.csv"))) > 100


def test_calibrate_max_a_equal_dp0_and_jax(art):
    got = {}
    for name, cli, extra in (("t2", tcli, CPU + ["--dp", "2"]),
                             ("t0", tcli, CPU),
                             ("j2", jcli, ["--dp", "2"])):
        out = str(art["tmp"] / f"cal_{name}")
        assert cli.main(["calibrate", "--out", out, "--weights",
                         art["weights"], "--batch-size", "2", "--limit",
                         "4"] + SIZE + extra) == 0
        got[name] = read_max_a(os.path.join(out, "results", "max_a.txt"))
    assert list(got["t2"]) == list(got["t0"]) == list(got["j2"])
    assert len(got["t2"]) == 64
    for tap, v in got["t2"].items():
        np.testing.assert_allclose(v, got["t0"][tap], rtol=1e-6, err_msg=tap)
        np.testing.assert_allclose(v, got["j2"][tap], rtol=1e-5, err_msg=tap)


def test_serve_jsonl_equal_dp0(art):
    """Byte-equal to --dp 0, whose JSONL test_torch_cli.py holds equal to
    the JAX CLI's."""
    outs = {}
    for name, extra in (("t2", ["--dp", "2"]), ("t0", [])):
        outs[name] = str(art["tmp"] / f"serve_{name}.jsonl")
        assert tcli.main(["serve", "--out", str(art["tmp"] / "s"),
                          "--weights", art["weights"], "--max-a",
                          art["max_a"], "--full-quant", "--input-list",
                          art["list"], "--max-batch", "4", "--output",
                          outs[name]] + SIZE + CPU + extra) == 1
    got = _read(outs["t2"])
    assert got == _read(outs["t0"])
    lines = [json.loads(ln) for ln in got.decode().splitlines()]
    assert len(lines) == 5 and "error" in lines[2]
    assert sum(ln.get("n", 0) for ln in lines) > 0


def test_accept_forwards_dp_to_every_gate(art, monkeypatch, capsys):
    from alpha_yolo_quant_torch.eval.harness import EvalResult

    seen = []

    def fake(name):
        def cmd(args):
            seen.append((name, args.dp, args.device))
            return EvalResult(map50_95=0.5, per_iou={}, n_images=4,
                              images_per_s=1.0) if name != "calibrate" \
                else 0
        return cmd

    for name in ("calibrate", "eval_float", "eval_int8"):
        monkeypatch.setattr(tcli, f"cmd_{name}", fake(name))
    rc = tcli.main(["accept", "--out", str(art["tmp"] / "acc" / "8_nano"),
                    "--coco-images", art["img_dir"], "--coco-ann",
                    art["ann"], "--batch-size", "2", "--dp", "2"]
                   + SIZE + CPU)
    assert rc == 0 and "ACCEPT: PASS" in capsys.readouterr().out
    assert seen == [("eval_float", 2, "cpu"), ("calibrate", 2, "cpu"),
                    ("eval_int8", 2, "cpu"), ("eval_int8", 2, "cpu")]


@pytest.mark.parametrize("dp", [1, 2])
def test_bench_dp_line(dp, capfd):
    assert tcli.main(["bench", "--batch", "2", "--iters", "1", "--dp",
                      str(dp)] + SIZE + CPU) == 0
    out, err = capfd.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["metric"] == "yolov8n_64_int8_e2e" + ("_dp2" if dp == 2
                                                      else "")
    assert line["device"] == "cpu" and line["mfu"] is None
    assert line["unit"] == "img/s" and line["value"] > 0
    assert "vs_baseline" not in line
    assert f"of 2 images over {dp} ranks" in err


def test_dp_errors_read_as_jax(art, monkeypatch):
    common = ["--weights", art["weights"], "--batch-size", "2", "--dp", "3"]
    coco = ["--coco-images", art["img_dir"], "--coco-ann", art["ann"]]
    for argv in (["calibrate"] + common,
                 ["eval-int8", "--max-a", art["max_a"]] + coco + common,
                 ["accept"] + coco + ["--batch-size", "2", "--dp", "3"]):
        msgs = []
        for cli, dev in ((tcli, CPU), (jcli, [])):
            with pytest.raises(SystemExit) as e:
                cli.main(argv + ["--out", str(art["tmp"] / "err")] + SIZE
                         + dev)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1] == "--dp 3 must divide the batch size 2"
    with pytest.raises(SystemExit, match="^--dp 3 must divide the batch "
                                         "size 4$"):
        tcli.main(["serve", "--max-a", art["max_a"], "--input-list",
                   art["list"], "--max-batch", "4", "--dp", "3"] + SIZE
                  + CPU)
    with pytest.raises(SystemExit, match="^--dp composes with --coalesce"):
        bench.main(image_size=64, batch=2, coalesce=2, device="cpu", dp=2)
    with pytest.raises(SystemExit, match="^--dp 2 must divide --batch 3$"):
        bench.main(image_size=64, batch=3, device="cpu", dp=2)
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="^--dp 2: only 1 devices visible$"):
        tcli.main(["calibrate", "--weights", art["weights"], "--dp", "2",
                   "--batch-size", "2", "--out", str(art["tmp"] / "err"),
                   "--device", "cuda"] + SIZE)
    with pytest.raises(SystemExit, match="^--dp 2: only 1 devices visible$"):
        bench.main(image_size=64, batch=2, device="cuda", dp=2)
