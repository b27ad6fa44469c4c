"""The port's eval/{metrics, map_oracle, records, harness, plots},
data/prefetch and utils/{run_log, debug_dump} against the JAX package's,
on the CPU.

The metrics are float64 numpy in both packages: the port's map50_95 and
average_precision equal JAX's and the port's loop oracle exactly (==) on
the fuzz cases of tests/test_map_oracle.py. Records, CSV tables, run logs
and debug dumps are byte-equal to JAX's. The harness scores an oracle
step at mAP 1.0 and gives JAX's rows and mAP on the same step, with and
without the prefetch pipeline (thread and process pools, device cpu)."""

import os

import numpy as np
import pytest

import conftest  # noqa: F401

import torch

from alpha_yolo_quant_tpu.data.coco import CocoValDataset as JDataset
from alpha_yolo_quant_tpu.eval import harness as jharness
from alpha_yolo_quant_tpu.eval import metrics as jmetrics
from alpha_yolo_quant_tpu.eval import records as jrecords
from alpha_yolo_quant_tpu.utils import debug_dump as jdump
from alpha_yolo_quant_tpu.utils import run_log as jrun_log
from alpha_yolo_quant_torch.data.coco import CocoValDataset, batches
from alpha_yolo_quant_torch.data.prefetch import prefetch_batches
from alpha_yolo_quant_torch.eval import map_oracle as toracle
from alpha_yolo_quant_torch.eval import metrics as tmetrics
from alpha_yolo_quant_torch.eval import plots
from alpha_yolo_quant_torch.eval import records as trecords
from alpha_yolo_quant_torch.eval.harness import evaluate
from alpha_yolo_quant_torch.utils import debug_dump as tdump
from alpha_yolo_quant_torch.utils import run_log as trun_log
from test_map_oracle import THRESHOLDS, _fuzz_case

RNG = np.random.default_rng(41)


@pytest.mark.parametrize("hard,seed0", [(False, 0), (True, 10_000)])
def test_metrics_equal_jax_and_oracle_on_fuzz_cases(hard, seed0):
    """200 smooth + 200 adversarial cases of tests/test_map_oracle.py x 3
    thresholds: per-class APs and means equal JAX's metric and the port's
    loop oracle exactly."""
    for case in range(200):
        ann, det = _fuzz_case(np.random.default_rng(seed0 + case), hard)
        for thr in THRESHOLDS:
            got = tmetrics.average_precision(ann, det, thr)
            assert got == jmetrics.average_precision(ann, det, thr), \
                (case, thr)
            assert got == toracle.mean_average_precision_for_boxes_oracle(
                ann, det, thr), (case, thr)


def test_map50_95_sweep_equal_jax_and_oracle():
    for case in range(30):
        ann, det = _fuzz_case(np.random.default_rng(20_000 + case),
                              hard=case % 2 == 1)
        got = tmetrics.map50_95(ann, det)
        assert got == jmetrics.map50_95(ann, det), case
        assert got == toracle.map50_95_oracle(ann, det), case


def _det_and_samples(n_img=4, max_det=300):
    dets, ns, samples = [], [], []
    for i in range(n_img):
        n = int(RNG.integers(0, 12))
        det = np.zeros((max_det, 6), np.float32)
        xy = RNG.uniform(0, 500, (n, 2))
        det[:n, :2] = xy
        det[:n, 2:4] = xy + RNG.uniform(1, 140, (n, 2))
        det[:n, 4] = RNG.uniform(0, 1, n)
        det[:n, 5] = RNG.integers(0, 80, n)
        m = int(RNG.integers(0, 5))
        boxes = np.concatenate([RNG.uniform(0, 200, (m, 2)),
                                RNG.uniform(3, 90, (m, 2))], 1)
        dets.append(det)
        ns.append(n)
        samples.append((10 * i + 3, boxes, RNG.integers(0, 80, m),
                        (int(RNG.integers(200, 600)),
                         int(RNG.integers(200, 600)))))
    return dets, ns, samples


def test_records_and_csv_tables_byte_equal_jax(tmp_path):
    assert trecords.COCO_NAMES == jrecords.COCO_NAMES
    assert len(trecords.COCO_NAMES) == 80
    dets, ns, samples = _det_and_samples()
    rows = {}
    for name, mod in (("t", trecords), ("j", jrecords)):
        ann_rows, det_rows = [], []
        for det, n, (iid, boxes, cls, hw) in zip(dets, ns, samples):
            ann_rows += mod.annotation_rows(iid, boxes, cls, hw)
            det_rows += mod.detection_rows(iid, det, n, frame=640.0)
        paths = mod.save_csv_tables(ann_rows, det_rows,
                                    str(tmp_path / name), "QUANT_8_channel")
        rows[name] = (ann_rows, det_rows,
                      [open(p, "rb").read() for p in paths])
        arrays = mod.to_metric_arrays(ann_rows, det_rows)
        rows[name] += tuple(a.tolist() for a in arrays)
    assert rows["t"] == rows["j"]
    assert len(rows["t"][1]) == sum(ns) > 0


def test_run_log_round_trip_and_cross_read(tmp_path):
    """The same lines as JAX's writer (the DATE stamp aside), and each
    package reads the other's results.txt."""
    for name, mod in (("t", trun_log), ("j", jrun_log)):
        os.makedirs(tmp_path / name / "results" / "runs_val")
        mod.write_run_result(str(tmp_path / name), 0.371, 4)
        mod.write_run_result(str(tmp_path / name), 0.362, 7, "int8")
        mod.write_run_result(str(tmp_path / name), 0.365, 7, "int8 minmae")

    def lines(name, rel):
        with open(tmp_path / name / "results" / rel) as f:
            return [ln for ln in f if not ln.startswith("DATE:")]

    for rel in ("ORIG_MODEL_MAP.txt", "runs_val/results.txt"):
        assert lines("t", rel) == lines("j", rel)
    runs = trun_log.read_run_results(str(tmp_path / "j"))
    assert [r["map"] for r in runs] == [0.362, 0.365]
    assert runs[1]["comment"] == "int8 minmae"
    assert runs == jrun_log.read_run_results(str(tmp_path / "t"))


def test_debug_dumps_byte_equal_jax(tmp_path):
    m = RNG.integers(-128, 128, (1, 2, 3, 4))
    env = {"edge:a": m, "x/b": np.float32(RNG.normal(size=(2, 5)))}
    for name, mod in (("t", tdump), ("j", jdump)):
        d = tmp_path / name
        d.mkdir()
        mod.result_txt(m, str(d / "r.txt"))
        mod.result_txt(m, str(d / "flat.txt"), flat=True)
        mod.matrix_txt(m, "M", str(d / "m.txt"))
        mod.matrix_txt(m[0, 0], "N", str(d / "m.txt"))
        mod.dump_env(env, str(d / "env"), names=["edge:a"])
        mod.dump_env(env, str(d / "all"))
    files = sorted(os.path.relpath(os.path.join(a, f), tmp_path / "t")
                   for a, _, fs in os.walk(tmp_path / "t") for f in fs)
    assert len(files) == 6
    for f in files:
        assert (tmp_path / "t" / f).read_bytes() == \
            (tmp_path / "j" / f).read_bytes(), f
    np.testing.assert_array_equal(np.load(tmp_path / "t" / "env" /
                                          "edge_a.npy"), m)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    """Five synthetic COCO images (tests_synth), one box each."""
    from tests_synth import write_synthetic_coco

    img_dir, ann = write_synthetic_coco(tmp_path_factory.mktemp("coco"), 5)
    return img_dir, ann


def _oracle_step(ds):
    """A step that returns each image's ground truth in the 640 frame, as
    tensors (the port's steps return tensors)."""
    order = iter([s for s in ds.samples])

    def step(imgs):
        b = imgs.shape[0]
        det = torch.zeros((b, 300, 6))
        n = torch.zeros((b,), dtype=torch.int32)
        for j in range(b):
            s = next(order, None)
            if s is None:
                continue
            h, w = s.orig_hw
            for bi, (x, y, bw, bh) in enumerate(s.boxes_xywh):
                det[j, bi] = torch.tensor(
                    [x / w * 640, y / h * 640, (x + bw) / w * 640,
                     (y + bh) / h * 640, 0.9, float(s.classes[bi])])
            n[j] = len(s.boxes_xywh)
        return det, n
    return step


@pytest.mark.parametrize("prefetch", [False, True])
def test_harness_oracle_step_equals_jax(coco, prefetch):
    """Batch 2 over 5 images (a padded tail): mAP 1.0, and the rows and
    mAP of JAX's harness on the same step (numpy out for JAX)."""
    ds = CocoValDataset(*coco)
    res = evaluate(_oracle_step(ds), ds, batch_size=2, image_size=640,
                   prefetch=prefetch, device="cpu")
    jstep = _oracle_step(ds)
    want = jharness.evaluate(
        lambda imgs: tuple(t.numpy() for t in jstep(imgs)),
        JDataset(*coco), batch_size=2, image_size=640)
    assert res.n_images == len(ds) == 5
    assert res.map50_95 == pytest.approx(1.0)
    assert (res.map50_95, res.per_iou, res.ann_rows, res.det_rows) == \
        (want.map50_95, want.per_iou, want.ann_rows, want.det_rows)
    assert res.images_per_s > 0 and res.images_per_s_wall > 0


@pytest.mark.parametrize("processes", [False, True],
                         ids=["threads", "processes"])
def test_prefetch_batches_equal_sync_reader(coco, processes):
    """Staged on the CPU as float32 tensors, the batches and their
    samples equal data.coco.batches; padded tail entries carry None."""
    ds = CocoValDataset(*coco)
    want = list(batches(ds, 2, 64))
    got = list(prefetch_batches(ds, 2, 64, processes=processes,
                                decode_workers=2, device="cpu"))
    assert len(got) == len(want) == 3
    for (wi, ws), (gi, gs) in zip(want, got):
        assert isinstance(gi, torch.Tensor) and gi.dtype == torch.float32
        np.testing.assert_allclose(gi.numpy(), wi, atol=1e-6, rtol=0)
        assert [s.image_id if s else None for s in ws] == \
            [s.image_id if s else None for s in gs]
    assert got[-1][1][-1] is None


def test_prefetch_reraises_a_decode_failure(coco, tmp_path):
    ds = CocoValDataset(*coco)
    ds.samples[3].path = str(tmp_path / "missing.jpg")
    with pytest.raises(FileNotFoundError):
        list(prefetch_batches(ds, 2, 64, device="cpu"))


def test_plots_write_pngs(tmp_path):
    """matplotlib is imported when a plot is drawn; each plot is a PNG."""
    from alpha_yolo_quant_torch.quantize.luts import sigmoid_lut

    os.makedirs(tmp_path / "results" / "runs_val")
    for m in (0.31, 0.30):
        trun_log.write_run_result(str(tmp_path), m, 7, "int8")
    paths = [plots.plot_run_results(str(tmp_path)),
             plots.plot_lut(sigmoid_lut(6.0, 8), str(tmp_path / "lut.png"))]
    plots.plot_detections(np.zeros((3, 64, 64), np.float32),
                          np.array([[4.0, 4.0, 30.0, 40.0]]), ["cat"],
                          [0.9], str(tmp_path / "det.png"))
    paths.append(str(tmp_path / "det.png"))
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", p
