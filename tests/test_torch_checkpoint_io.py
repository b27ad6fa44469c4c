"""The port's checkpoint ingest, parameter and calibration files, activation
dumps and COCO reader against the JAX package's, on the same inputs and
files. Bit-exact (files byte-equal) unless a test states its tolerance."""

import collections
import os

import numpy as np
import pytest

import conftest  # noqa: F401

import torch

from alpha_yolo_quant_tpu.config import QuantConfig as JConfig
from alpha_yolo_quant_tpu.data import coco as jcoco
from alpha_yolo_quant_tpu.models import graph as jgraph
from alpha_yolo_quant_tpu.models import params as jparams
from alpha_yolo_quant_tpu.quantize import calibrate as jcal
from alpha_yolo_quant_tpu.quantize.transform import (
    build_quantized_model as j_build,
)
from alpha_yolo_quant_tpu.utils import io as jio
from alpha_yolo_quant_tpu.utils import params_io as jpio
from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.data import coco as tcoco
from alpha_yolo_quant_torch.models import graph as tgraph
from alpha_yolo_quant_torch.models import params as tparams
from alpha_yolo_quant_torch.quantize import calibrate as tcal
from alpha_yolo_quant_torch.quantize.transform import build_quantized_model
from alpha_yolo_quant_torch.utils import io as tio
from alpha_yolo_quant_torch.utils import params_io as tpio
from test_torch_model_build import assert_same

RNG = np.random.default_rng(23)


def synthetic_checkpoint(graph, raw, path):
    """torch.save a state dict of ``raw``'s tensors in the checkpoint's
    slot order under opaque ultralytics-style names (the remap is
    positional, reference stage_1.py:771-783)."""
    sd = collections.OrderedDict()
    i = 0
    for key, fields in tparams.raw_param_slots(graph):
        for f in fields:
            sd[f"model.model.{i}.t"] = torch.from_numpy(
                np.array(raw[key][f]))
            i += 1
    torch.save(sd, str(path))
    return i


def test_max_a_files_byte_equal_and_cross_read(tmp_path):
    max_a = {"start": 1.0, "conv_p1": 4.843660564822945,
             "conv_p2": float(np.float32(0.1)), "c2f_2": 1e-7,
             "x_up_2": 123456.789}
    records = {"conv_p1": [0.5, 1.25, float(np.float32(3.3))],
               "conv_p2": [2.0], "c2f_2": []}
    files = {}
    for name, mod in (("t", tio), ("j", jio)):
        mod.write_max_a(str(tmp_path / f"{name}_max_a.txt"), max_a)
        mod.write_max_a_all(str(tmp_path / f"{name}_all.txt"), records)
        files[name] = [(tmp_path / f"{name}_{f}.txt").read_bytes()
                       for f in ("max_a", "all")]
    assert files["t"] == files["j"]
    for reader, writer in ((tio, "j"), (jio, "t")):
        assert reader.read_max_a(str(tmp_path / f"{writer}_max_a.txt")) \
            == max_a
        assert reader.read_max_a_all(str(tmp_path / f"{writer}_all.txt")) \
            == records
    # the reference's stage-4 dump: a list of torch scalar reprs
    ref = tmp_path / "ref_all.txt"
    ref.write_text("conv_p1: [tensor(0.9686, device='cuda:0'), "
                   "tensor(1.2500, device='cuda:0')]\nconv_p2: "
                   "[tensor(3.)]\n")
    assert tio.read_max_a_all(str(ref)) == jio.read_max_a_all(str(ref)) \
        == {"conv_p1": [0.9686, 1.25], "conv_p2": [3.0]}


def test_params_npz_cross_read(tmp_path):
    graph = tgraph.build_yolov8_graph(QuantConfig(image_size=64))
    params = tparams.init_params(graph, seed=2)
    tpio.save_params(params, str(tmp_path / "t.npz"))
    jpio.save_params(params, str(tmp_path / "j.npz"))
    for path in ("t.npz", "j.npz"):
        for mod in (tpio, jpio):
            assert_same(mod.load_params(str(tmp_path / path)), params,
                        f"{mod.__name__} {path}")


@pytest.mark.parametrize("model", ["yolov8n", "yolov8m"])
def test_checkpoint_ingest_equals_jax(tmp_path, model):
    """A synthetic checkpoint, saved with torch.save in slot order, loads
    to the same raw arrays, fuses to the same f32 params (bit for bit:
    multiply by gamma, then divide by the f32 sqrt), and builds the same
    QuantizedModel in both packages."""
    cfg = QuantConfig(model=model, full_quant=True, image_size=64)
    jcfg = JConfig(model=model, full_quant=True, image_size=64)
    graph = tgraph.build_yolov8_graph(cfg)
    jg = jgraph.build_yolov8_graph(jcfg)
    raw = tparams.init_raw_params(graph, seed=5)
    assert_same(raw, jparams.init_raw_params(jg, seed=5), "init_raw")
    ckpt = tmp_path / f"synthetic_{model}.pt"
    n = synthetic_checkpoint(graph, raw, ckpt)
    assert n == {"yolov8n": 355, "yolov8m": 475}[model]
    t_raw = tparams.load_torch_checkpoint(graph, str(ckpt))
    j_raw = jparams.load_torch_checkpoint(jg, str(ckpt))
    assert_same(t_raw, j_raw, "raw")
    assert_same({k: t_raw[k] for k in raw}, raw, "raw vs saved")
    fused = tparams.fuse_batchnorm(graph, t_raw)
    assert_same(fused, jparams.fuse_batchnorm(jg, j_raw), "fused")
    assert all(p["w"].dtype == np.float32 for p in fused.values())
    calib = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    max_a = tcal.reduce_stats(tcal.collect_stats(graph, fused, [calib],
                                                 "cpu"), "max", 8)
    assert_same(build_quantized_model(graph, fused, max_a, cfg),
                j_build(jg, fused, max_a, jcfg), f"{model} model")
    with pytest.raises(ValueError, match="expected"):
        other = "yolov8m" if model == "yolov8n" else "yolov8n"
        tparams.load_torch_checkpoint(
            tgraph.build_yolov8_graph(QuantConfig(model=other)), str(ckpt))


def test_activation_dumps_cross_load_and_min_mae(tmp_path):
    """collect_samples agrees with JAX within rtol 1e-5 of each tap's
    largest magnitude (float convs are not bit-identical across
    frameworks); each package loads the other's gzip-pickle dumps to the
    same arrays; fed the same samples, min_mae gives the same max_a."""
    graph = tgraph.build_yolov8_graph(QuantConfig(image_size=64))
    jg = jgraph.build_yolov8_graph(JConfig(image_size=64))
    params = tparams.init_params(graph, seed=6)
    batches = [RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
               for _ in range(2)]
    taps = ["conv_p2", "conv_b_1_c2f", "x_up_2"]
    assert all(any(c.tap == t for c in graph.convs()) for t in taps)
    got = tcal.collect_samples(graph, params, batches, taps, "cpu")
    want = jcal.collect_samples(jg, params, batches, taps)
    for t in taps:
        assert got[t].dtype == np.float32 and got[t].shape == want[t].shape
        assert got[t].shape[0] == 4
        np.testing.assert_allclose(got[t], want[t], rtol=1e-5,
                                   atol=1e-5 * np.abs(want[t]).max(),
                                   err_msg=t)
    tcal.save_batches(str(tmp_path / "t"), got)
    jcal.save_batches(str(tmp_path / "j"), want)
    assert sorted(os.listdir(tmp_path / "t" / "batches" / taps[0])) == \
        [f"b_{i}.pickle" for i in range(4)]
    for loader in (tcal.load_batches, jcal.load_batches):
        assert_same(loader(str(tmp_path / "j"), taps), want, "j dumps")
        assert_same(loader(str(tmp_path / "t"), taps), got, "t dumps")
        assert loader(str(tmp_path / "t"), taps + ["conv7"]) is None
    records = tcal.collect_stats(graph, params, batches, "cpu")
    records = {k: v for k, v in records.items() if k in taps}
    assert tcal.reduce_stats(records, "min_mae", 8, want) == \
        jcal.reduce_stats(records, "min_mae", 8, want)


def test_coco_reader_equals_jax(tmp_path):
    from tests_synth import write_synthetic_coco

    img_dir, ann = write_synthetic_coco(tmp_path, n_images=3)
    tds = tcoco.CocoValDataset(img_dir, ann, limit=3)
    jds = jcoco.CocoValDataset(img_dir, ann, limit=3)
    assert len(tds) == len(jds) == 3 and tds.cat_to_idx == jds.cat_to_idx
    for a, b in zip(tds.samples, jds.samples):
        assert (a.image_id, a.path, a.orig_hw) == (b.image_id, b.path,
                                                   b.orig_hw)
        np.testing.assert_array_equal(a.boxes_xywh, b.boxes_xywh)
        np.testing.assert_array_equal(a.classes, b.classes)
    got = list(tcoco.batches(tds, 2, 64))
    want = list(jcoco.batches(jds, 2, 64))
    assert len(got) == len(want) == 2
    for (ti, ts), (ji, js) in zip(got, want):
        assert ti.dtype == np.float32 and ti.shape == (2, 3, 64, 64)
        np.testing.assert_array_equal(ti, ji)
        assert [s and s.image_id for s in ts] == \
            [s and s.image_id for s in js]
    assert got[1][1][1] is None     # the tail batch repeats its last image
