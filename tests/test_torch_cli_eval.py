"""The port's CLI quantize, eval-int8, eval-float, serve --from-artifacts
and accept against the JAX package's CLI, on the CPU at 64 px over five
synthetic COCO images (tests_synth), from one set of float weights and one
max_a.txt (JAX's prepare and calibrate).

- quantize: the artifact tree equals JAX's file by file (the torch zip as
  tensors);
- eval-int8 full quant: the det/ann CSVs and results.txt's lines are
  byte-equal to JAX's, and so is the printed mAP;
- eval-int8 float NMS (partial quant, float head): per image the same
  detection count and classes, boxes within 1e-3 px and scores within
  rtol 1e-5 (the partial-quant pipeline tolerance of
  test_torch_pipeline.py: f32 softmax, DFL dot and sigmoid in another
  order), mAP within 1e-6;
- eval-float (fp32 convs, TF32 off in both): mAP within 1e-6, detections
  within the tolerance of the float forward (see test_eval_float);
- serve --from-artifacts: JSONL byte-equal to JAX's from JAX's tree, and
  to the port's own weights-path serve;
- accept --k-sweep 4 on the CPU: exit code 0, every gate's files and
  report lines.
"""

import csv
import os

import numpy as np
import pytest

import conftest  # noqa: F401

from alpha_yolo_quant_tpu import cli as jcli
from alpha_yolo_quant_torch import cli as tcli
from test_torch_export import assert_trees_equal

SIZE = ["--image-size", "64"]


def _main(cli, argv, capsys):
    """Run a CLI; return (exit code, stdout)."""
    capsys.readouterr()
    rc = cli.main(argv)
    return rc, capsys.readouterr().out


@pytest.fixture(scope="module")
def art(tmp_path_factory):
    """JAX's prepare + calibrate, the synthetic COCO set, and both CLIs'
    quantize --full-quant trees."""
    from tests_synth import write_synthetic_coco

    tmp = tmp_path_factory.mktemp("cli_eval")
    base = str(tmp / "base" / "8_nano")
    assert jcli.main(["prepare", "--out", base] + SIZE) == 0
    weights = os.path.join(base, "results", "weights_batchnf.npz")
    assert jcli.main(["calibrate", "--out", base, "--weights", weights,
                      "--batch-size", "2", "--limit", "4"] + SIZE) == 0
    img_dir, ann = write_synthetic_coco(tmp, n_images=5)
    a = {"tmp": tmp, "weights": weights, "img_dir": img_dir, "ann": ann,
         "max_a": os.path.join(base, "results", "max_a.txt"),
         "t": str(tmp / "t" / "8_nano"), "j": str(tmp / "j" / "8_nano")}
    for name, cli in (("t", tcli), ("j", jcli)):
        assert cli.main(["quantize", "--out", a[name], "--weights", weights,
                         "--max-a", a["max_a"], "--full-quant"] + SIZE) == 0
    return a


def _eval_argv(a, cmd, out, *extra):
    argv = [cmd, "--out", out, "--weights", a["weights"], "--coco-images",
            a["img_dir"], "--coco-ann", a["ann"], "--batch-size", "2",
            *SIZE, *extra]
    if cmd == "eval-int8":
        argv += ["--max-a", a["max_a"]]
    return argv


def _map_line(out):
    return next(ln for ln in out.splitlines() if ln.startswith("mAP50-95:"))


def _det_rows(out, tag):
    with open(os.path.join(out, "results", f"det_{tag}.csv")) as f:
        return list(csv.reader(f))


def _run_both(a, capsys, cmd, tag, *extra):
    """(port EvalResult-free outputs): per CLI its stdout mAP line and its
    out dir; JAX runs the xla engine for eval-int8."""
    got = {}
    for name, cli in (("t", tcli), ("j", jcli)):
        out = str(a["tmp"] / f"{cmd}_{tag}_{name}")
        dev = (["--device", "cpu"] if name == "t" else
               ["--engine", "xla"] if cmd == "eval-int8" else [])
        rc, stdout = _main(cli, _eval_argv(a, cmd, out, *extra, *dev),
                           capsys)
        assert rc == 0
        got[name] = (_map_line(stdout), out)
    return got


def _results_lines(out, rel):
    with open(os.path.join(out, "results", rel)) as f:
        return [ln for ln in f if not ln.startswith("DATE:")]


def test_quantize_tree_equals_jax(art):
    assert_trees_equal(art["t"], art["j"], 8)


def test_eval_int8_full_quant_equals_jax(art, capsys):
    got = _run_both(art, capsys, "eval-int8", "QUANT_8_channel",
                    "--full-quant")
    (line_t, out_t), (line_j, out_j) = got["t"], got["j"]
    assert line_t.split(" (")[0] == line_j.split(" (")[0]
    assert " over 5 images " in line_t
    for f in ("ann_QUANT_8_channel.csv", "det_QUANT_8_channel.csv"):
        with open(os.path.join(out_t, "results", f), "rb") as ft, \
                open(os.path.join(out_j, "results", f), "rb") as fj:
            assert ft.read() == fj.read(), f
    assert len(_det_rows(out_t, "QUANT_8_channel")) > 5
    lines = _results_lines(out_t, "runs_val/results.txt")
    assert lines == _results_lines(out_j, "runs_val/results.txt")
    assert "Comments: int8 full-quant q_NMS\n" in lines
    assert os.path.exists(os.path.join(out_t, "results", "runs_val",
                                       "runs.png"))


def _assert_rows_close(out_t, out_j, tag, box_px, score_rtol):
    """Same rows per image in the same order with the same labels; boxes
    (normalized by 640) within box_px pixels, scores within score_rtol."""
    rt, rj = _det_rows(out_t, tag), _det_rows(out_j, tag)
    assert rt[0] == rj[0] and len(rt) == len(rj) > 5
    t = np.array([r[:4] + [r[6]] for r in rt[1:]], np.float64)
    j = np.array([r[:4] + [r[6]] for r in rj[1:]], np.float64)
    assert [r[4:6] for r in rt] == [r[4:6] for r in rj]
    np.testing.assert_allclose(t[:, :4] * 640, j[:, :4] * 640, rtol=0,
                               atol=box_px)
    np.testing.assert_allclose(t[:, 4], j[:, 4], rtol=score_rtol)


def _map_value(line):
    return float(line.split()[1])


def test_eval_int8_float_nms_matches_jax(art, capsys):
    got = _run_both(art, capsys, "eval-int8", "QUANT_8_channel")
    (line_t, out_t), (line_j, out_j) = got["t"], got["j"]
    _assert_rows_close(out_t, out_j, "QUANT_8_channel", 1e-3, 1e-5)
    assert abs(_map_value(line_t) - _map_value(line_j)) <= 1e-6
    with open(os.path.join(out_t, "results", "ann_QUANT_8_channel.csv"),
              "rb") as ft, open(os.path.join(
                  out_j, "results", "ann_QUANT_8_channel.csv"), "rb") as fj:
        assert ft.read() == fj.read()
    assert "Comments: int8 float NMS\n" in _results_lines(
        out_t, "runs_val/results.txt")


def test_eval_float(art, capsys):
    """The fp32 forward differs between the frameworks in the last bits
    of its convs (rtol 1e-4 on the head maps, test_torch_pipeline.py):
    the same detections per image, boxes within 1e-2 px, scores within
    rtol 1e-4; mAP within 1e-6. ORIG_MODEL_MAP.txt and the orig CSVs."""
    got = _run_both(art, capsys, "eval-float", "orig")
    (line_t, out_t), (line_j, out_j) = got["t"], got["j"]
    _assert_rows_close(out_t, out_j, "orig", 1e-2, 1e-4)
    assert abs(_map_value(line_t) - _map_value(line_j)) <= 1e-6
    lines = _results_lines(out_t, "ORIG_MODEL_MAP.txt")
    assert len(lines) == 1 and lines[0].startswith("ORIG MODEL mAP")
    assert os.path.exists(os.path.join(out_t, "results", "ann_orig.csv"))


def test_serve_from_artifacts_equals_jax(art, capsys):
    img_dir = art["img_dir"]
    paths = sorted(os.path.join(img_dir, f) for f in os.listdir(img_dir))
    listing = art["tmp"] / "list.txt"
    listing.write_text("\n".join(paths) + "\n")
    common = ["serve", *SIZE, "--full-quant", "--input-list", str(listing),
              "--max-batch", "4", "--max-wait-ms", "50"]
    jsonl = {}
    for name, cli, extra in (
            ("j", jcli, ["--out", art["j"], "--from-artifacts",
                         "--engine", "xla"]),
            ("t", tcli, ["--out", art["t"], "--from-artifacts",
                         "--device", "cpu"]),
            ("w", tcli, ["--out", art["t"], "--weights", art["weights"],
                         "--max-a", art["max_a"], "--device", "cpu"])):
        path = str(art["tmp"] / f"serve_{name}.jsonl")
        assert cli.main(common + extra + ["--output", path]) == 0
        with open(path, "rb") as f:
            jsonl[name] = f.read()
    assert jsonl["t"] == jsonl["j"] == jsonl["w"]
    assert jsonl["t"].count(b"\n") == len(paths) == 5


def test_serve_needs_max_a_or_artifacts(art):
    with pytest.raises(SystemExit, match="--max-a is required"):
        tcli.main(["serve", "--input-list", "-", "--device", "cpu"] + SIZE)


def test_accept_k_sweep(art, capsys):
    """prepare -> fp32 gate -> calibrate -> int gates at K=8 and K=4 on
    the CPU; random weights give an mAP near 0 everywhere, so every drop
    is within the 0.5 budget."""
    out = str(art["tmp"] / "accept" / "8_nano")
    rc, stdout = _main(tcli, [
        "accept", "--out", out, "--coco-images", art["img_dir"],
        "--coco-ann", art["ann"], "--batch-size", "2", "--limit", "4",
        "--k-sweep", "4", "--device", "cpu"] + SIZE, capsys)
    assert rc == 0 and stdout.rstrip().endswith("ACCEPT: PASS")
    report = stdout[stdout.index("== acceptance report =="):]
    for label in ("fp32 baseline", "int8 float-NMS", "int8 full-quant",
                  "int4 float-NMS", "int4 full-quant"):
        assert f"\n{label}" in report, label
    assert report.count("PASS (budget 0.5)") == 4
    out4 = os.path.join(os.path.dirname(out), "4_nano")
    assert os.path.exists(os.path.join(out, "results", "ORIG_MODEL_MAP.txt"))
    assert os.path.exists(os.path.join(out, "results", "ann_orig.csv"))
    for d, k in ((out, 8), (out4, 4)):
        assert os.path.exists(os.path.join(d, "results", "max_a.txt"))
        assert os.path.exists(os.path.join(
            d, "results", f"det_QUANT_{k}_channel.csv"))
        comments = [ln for ln in _results_lines(d, "runs_val/results.txt")
                    if ln.startswith("Comments:")]
        assert comments == [f"Comments: int{k} float NMS\n",
                            f"Comments: int{k} full-quant q_NMS\n"]
