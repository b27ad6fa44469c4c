"""The port's dp, tp and sp meshes (parallel/mesh.py) against the JAX
package at 64 px, on the CPU over gloo ranks.

Four ranks, spawned once for the module (tests/_torch_ranks.py
parallel_checks), give: dp over 2 and 4 ranks, whose detections equal
JAX's jitted pipeline bit for bit; the calibration taps' MAX all-reduce,
within rtol 1e-6 of JAX's forward_float (tests/test_parallel.py's
tolerance); tp over 2 ranks and on a 2x2 dp x tp mesh, within rtol = atol
= 2e-4 of JAX's float preds (test_parallel.py's); sp over 2 ranks and on a
2x2 dp x sp mesh, whose preds equal JAX's jitted with_nms=False pipeline
and the port's unsharded one bit for bit. All JAX values come from one
jitted program. Two OS processes launched apart join through
init_distributed's environment rendezvous, and dryrun_multichip runs two
CPU ranks from its command line in a fresh process (and stops without a
card unless asked for the CPU).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

import _torch_ranks
from alpha_yolo_quant_tpu.config import QuantConfig as JConfig
from alpha_yolo_quant_tpu.models.forward import forward_float as j_forward
from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph as j_graph
from alpha_yolo_quant_tpu.models.head import decode_float as j_decode
from alpha_yolo_quant_tpu.quantize.transform import (
    build_quantized_model as j_build,
)
from alpha_yolo_quant_tpu.runtime import interpreter as jinterp
from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.models.graph import build_yolov8_graph
from alpha_yolo_quant_torch.models.params import init_params
from alpha_yolo_quant_torch.parallel.mesh import free_port, run_ranks
from alpha_yolo_quant_torch.quantize.calibrate import (
    collect_stats, reduce_stats,
)
from alpha_yolo_quant_torch.quantize.transform import build_quantized_model
from alpha_yolo_quant_torch.runtime.interpreter import build_int_pipeline
from test_torch_model_build import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IMAGES = np.random.default_rng(17).uniform(
    0, 1, (4, 3, 64, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    """The port's graph, params and full-quant model, JAX's model from the
    same params and max_a, and JAX's values for IMAGES from one jit:
    detections, with_nms=False preds, per-image tap maxima, float preds."""
    cfg = QuantConfig(model="yolov8n", k=8, full_quant=True, image_size=64)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=0)
    calib = np.random.default_rng(1).uniform(
        0, 1, (2, 3, 64, 64)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib], "cpu"),
                         "max")
    model = build_quantized_model(graph, params, max_a, cfg)
    jcfg = JConfig(model="yolov8n", k=8, full_quant=True, image_size=64)
    jg = j_graph(jcfg)
    jmodel = j_build(jg, params, max_a, jcfg)
    jfn, _ = jinterp.build_int_pipeline(jmodel, engine="xla")
    jpreds, _ = jinterp.build_int_pipeline(jmodel, engine="xla",
                                           with_nms=False)

    def everything(x):
        outs, taps = j_forward(jg, params, x, collect_taps=True)
        return (jfn(x), jpreds(x), taps,
                j_decode(outs, params["dfl"]["w"]))

    dets, preds, taps, fpreds = jax.jit(everything)(jnp.asarray(IMAGES))
    want = {"dets": tuple(np.asarray(t) for t in dets),
            "preds": np.asarray(preds),
            "taps": {k: float(np.max(np.asarray(v)))
                     for k, v in taps.items()},
            "float_preds": np.asarray(fpreds)}
    return graph, params, model, want


@pytest.fixture(scope="module")
def ranks(setup):
    graph, params, model, _ = setup
    return run_ranks(_torch_ranks.parallel_checks,
                     (graph, params, model, IMAGES), 4, "gloo",
                     deadline_s=300)


@pytest.mark.parametrize("world", [2, 4])
def test_dp_detections_equal_jax(setup, ranks, world):
    _, _, model, want = setup
    det, n = ranks[f"dp{world}"]
    assert det.shape == (4, 300, 6) and int(n.sum()) > 0
    np.testing.assert_array_equal(n, want["dets"][1])
    np.testing.assert_array_equal(det, want["dets"][0])
    det1, n1 = build_int_pipeline(model, "cpu")[0](IMAGES)
    np.testing.assert_array_equal(det, det1.numpy())


def test_calibration_taps_all_reduce_equal_jax(setup, ranks):
    taps, want = ranks["taps"], setup[3]["taps"]
    assert sorted(taps) == sorted(want) and "conv_p1" in taps
    for name, v in taps.items():
        np.testing.assert_allclose(float(v), want[name], rtol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("mesh", ["tp2", "dp2tp2"])
def test_tp_float_preds_equal_jax(setup, ranks, mesh):
    want = setup[3]["float_preds"]
    assert ranks[mesh].shape == want.shape
    np.testing.assert_allclose(ranks[mesh], want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mesh", ["sp2", "dp2sp2"])
def test_sp_preds_bitwise(setup, ranks, mesh):
    _, _, model, want = setup
    np.testing.assert_array_equal(ranks[mesh], want["preds"])
    ref = build_int_pipeline(model, "cpu", with_nms=False)[0](IMAGES)
    np.testing.assert_array_equal(ranks[mesh], ref.numpy())


def test_sp_rejects_a_split_of_the_deepest_map(ranks):
    """sp must divide image_size/32 (2 rows at 64 px), as in JAX."""
    assert ranks["sp3"] == ("sp=3 must divide the deepest feature-map "
                            "height image_size/32 = 2")


def test_replicate_leaves_the_first_ranks_leaves_everywhere(ranks):
    """replicate over a 2x2 mesh: every rank holds rank 0's tensor and
    numpy leaves."""
    np.testing.assert_array_equal(ranks["replicated"], [0.5, 0.5, 0.0] * 4)


_WORKER = textwrap.dedent("""
    import numpy as np
    import torch
    from alpha_yolo_quant_torch.config import QuantConfig
    from alpha_yolo_quant_torch.models.forward import forward_float
    from alpha_yolo_quant_torch.models.graph import build_yolov8_graph
    from alpha_yolo_quant_torch.models.params import (
        init_params, params_to_torch)
    from alpha_yolo_quant_torch.parallel.mesh import (
        data_parallel_step, gather_batch, init_distributed, make_mesh,
        sharded_forward_fn)
    from alpha_yolo_quant_torch.quantize.calibrate import (
        collect_stats, reduce_stats)
    from alpha_yolo_quant_torch.quantize.transform import (
        build_quantized_model)
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline)
    torch.set_num_threads(1)
    dev = init_distributed("gloo")
    assert dev.type == "cpu" and torch.distributed.get_world_size() == 2
    cfg = QuantConfig(model="yolov8n", k=8, full_quant=True, image_size=64)
    g = build_yolov8_graph(cfg)
    p = init_params(g, seed=0)
    x = np.random.default_rng(23).uniform(0, 1, (2, 3, 64, 64)).astype(
        np.float32)
    mesh = make_mesh()
    tp = params_to_torch(p, "cpu")
    taps = sharded_forward_fn(g, mesh, collect_taps=True)(tp, x)["taps"]
    with torch.no_grad():
        _, local = forward_float(g, tp, torch.as_tensor(x),
                                 collect_taps=True)
    for name in ("conv_p1", "x_down_2"):
        np.testing.assert_allclose(float(taps[name]),
                                   float(local[name].max()), rtol=1e-6)
    m = build_quantized_model(g, p, reduce_stats(collect_stats(
        g, p, [x], "cpu")), cfg)
    fn, _ = build_int_pipeline(m, "cpu")
    det, n = gather_batch(mesh, data_parallel_step(fn, mesh)(x))
    det1, n1 = fn(x)
    assert torch.equal(det, det1) and torch.equal(n, n1)
    print("RANK_OK", torch.distributed.get_rank())
""")


def test_two_processes_join_through_the_environment():
    """Two OS processes launched apart, as a launcher (torchrun) starts
    them: RANK, WORLD_SIZE and a MASTER_ADDR/MASTER_PORT store in their
    environment, init_distributed with no arguments. The calibration
    all-reduce and the dp serving step across them equal the one-process
    run."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE="2", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER], cwd=REPO,
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-3000:]
        assert f"RANK_OK {r}" in out


def test_dryrun_multichip_two_cpu_ranks_in_a_fresh_process():
    """The module's command line on two gloo ranks: dp and sp=2 (the
    four-rank seams are the fixtures' checks above)."""
    res = subprocess.run(
        [sys.executable, "-m", "alpha_yolo_quant_torch.parallel.dryrun", "2",
         "--device", "cpu"], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {
        "world": 2, "checks": ["dp2", "calibration", "sp2"]}


def test_dryrun_multichip_defaults_to_the_card(monkeypatch):
    import torch

    from alpha_yolo_quant_torch.parallel.dryrun import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match=r"^dryrun_multichip\(2\): only 0 "
                                         "CUDA devices visible"):
        dryrun_multichip(2)
