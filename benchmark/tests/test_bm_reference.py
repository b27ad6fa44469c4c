"""The plain reference equals the program's serving pipeline bit for bit
on the CPU (the program's kernels run their plain versions there), from
the benchmark's own seeded weights and calibration; and the reference one
precision lower (K=4 for K=8) does not."""

import numpy as np
import pytest

from benchmark import inputs, program, run, spec

NMS = {"conf_thres_int": 8192, "iou_thres": 0.45, "pre_topk": 1000,
       "max_det": 300, "max_wh": 7680.0}


def _config(model, size):
    return {"model": model, "k": 8, "full_quant": True, "image_size": size,
            "koeff_bits": 8, "engine": "fused", "nms": NMS}


def _setup(model, size, seed):
    config = _config(model, size)
    ref = spec.reference(config)
    graph = ref.graph.build_yolov8_graph(run.ref_cfg(config))
    seeds = inputs.Seeds(seed)
    params = inputs.make_params(graph, seeds, "cpu")
    max_a = inputs.make_max_a(ref, graph, params, seeds, 2, size, "cpu")
    images = inputs.make_pool(seeds, 4, size, "cpu")
    return config, params, max_a, images


@pytest.mark.parametrize("model,size,seed", [
    ("yolov8n", 64, 1), ("yolov8n", 64, 2 ** 31 + 5), ("yolov8n", 160, 3),
    ("yolov8m", 64, 4)])
def test_reference_equals_program(one_thread, model, size, seed):
    config, params, max_a, images = _setup(model, size, seed)
    det, n = program.build(config, params, max_a, "cpu")(images)
    rdet, rn = run.reference_fn(config, params, max_a, 8, "cpu")(images)
    assert np.array_equal(n.numpy(), rn.numpy())
    assert n.sum() > 0
    assert np.array_equal(det.numpy(), rdet.numpy())


def test_lower_precision_reference_differs(one_thread):
    config, params, max_a, images = _setup("yolov8n", 64, 6)
    det, n = program.build(config, params, max_a, "cpu")(images)
    rdet, rn = run.reference_fn(config, params, max_a, 4, "cpu")(images)
    differ = [not (int(n[i]) == int(rn[i])
                   and np.array_equal(det[i].numpy(), rdet[i].numpy()))
              for i in range(len(images))]
    assert sum(differ) >= 3


@pytest.mark.parametrize("over", (
    {"koeff_bits": 10},
    {"nms": dict(NMS, conf_thres_int=12000, iou_thres=0.6, pre_topk=200,
                 max_det=20)}))
def test_program_runs_the_configured_quantizer_and_nms(one_thread, over):
    """What the configuration file states reaches the program and the
    reference alike: both agree, and both differ from the defaults."""
    config, params, max_a, images = _setup("yolov8n", 64, 7)
    config = dict(config, **over)
    det, n = program.build(config, params, max_a, "cpu")(images)
    rdet, rn = run.reference_fn(config, params, max_a, 8, "cpu")(images)
    assert np.array_equal(n.numpy(), rn.numpy()) and n.sum() > 0
    assert np.array_equal(det.numpy(), rdet.numpy())
    ddet, dn = program.build(_config("yolov8n", 64), params, max_a,
                             "cpu")(images)
    assert not (np.array_equal(n.numpy(), dn.numpy())
                and det.shape == ddet.shape
                and np.array_equal(det.numpy(), ddet.numpy()))
