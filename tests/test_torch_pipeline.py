"""The PyTorch port's serving pipeline and calibration against the JAX
package at the 64-px scale, and the port's independence from JAX."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from alpha_yolo_quant_tpu.config import QuantConfig
from alpha_yolo_quant_tpu.models.forward import forward_float as j_forward
from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
from alpha_yolo_quant_tpu.models.params import init_params
from alpha_yolo_quant_tpu.quantize import calibrate as jcal
from alpha_yolo_quant_tpu.quantize.transform import build_quantized_model
from alpha_yolo_quant_tpu.runtime import interpreter as jinterp
from alpha_yolo_quant_torch.models.forward import forward_float
from alpha_yolo_quant_torch.models.params import params_to_torch
from alpha_yolo_quant_torch.quantize import calibrate as tcal
from alpha_yolo_quant_torch.runtime.interpreter import build_int_pipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(17)


def _model(full=True, k=8, seed=3):
    cfg = QuantConfig(model="yolov8n", k=k, full_quant=full, image_size=64)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=seed)
    calib = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    max_a = tcal.reduce_stats(tcal.collect_stats(graph, params, [calib]),
                              "max", k)
    return build_quantized_model(graph, params, max_a, cfg), params


@pytest.fixture(scope="module")
def full_model():
    return _model()[0]


def _assert_dets_equal(got, want, msg=""):
    det_t, n_t = got
    det_j, n_j = want
    assert det_t.shape == tuple(det_j.shape) and det_t.dtype == torch.float32
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j), err_msg=msg)
    np.testing.assert_array_equal(det_t.numpy(), np.asarray(det_j),
                                  err_msg=msg)


@pytest.mark.parametrize("dtype", ["f32", "uint8"])
def test_pipeline_equals_jax(full_model, dtype):
    if dtype == "f32":
        x = RNG.uniform(0, 1, (3, 3, 64, 64)).astype(np.float32)
    else:
        x = RNG.integers(0, 256, (3, 3, 64, 64)).astype(np.uint8)
    jfn, _ = jinterp.build_int_pipeline(full_model, engine="xla")
    want = jax.jit(jfn)(jnp.asarray(x))
    fn, _ = build_int_pipeline(full_model, "cpu")
    got = fn(x)
    assert int(got[1].sum()) > 0, "test input must produce detections"
    _assert_dets_equal(got, want, dtype)


def test_pipeline_pad_batch_to_equals_jax(full_model):
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    jfn, _ = jinterp.build_int_pipeline(full_model, engine="xla",
                                        pad_batch_to=5)
    fn, _ = build_int_pipeline(full_model, "cpu", pad_batch_to=5)
    got = fn(x)
    _assert_dets_equal(got, jax.jit(jfn)(jnp.asarray(x)), "padded")
    plain_fn, _ = build_int_pipeline(full_model, "cpu")
    _assert_dets_equal(got, plain_fn(x), "padded vs unpadded")


def test_pipeline_coalesce_requests_equals_jax(full_model):
    reqs = [RNG.integers(0, 256, (2, 3, 64, 64)).astype(np.uint8),
            RNG.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32),
            RNG.uniform(0, 1, (3, 3, 64, 64)).astype(np.float32)]
    jfn, _ = jinterp.build_int_pipeline(full_model, engine="xla",
                                        coalesce_requests=3)
    want = jax.jit(jfn)(*[jnp.asarray(r) for r in reqs])
    fn, _ = build_int_pipeline(full_model, "cpu", coalesce_requests=3)
    got = fn(*reqs)
    assert len(got) == 3
    single, _ = build_int_pipeline(full_model, "cpu")
    for i, r in enumerate(reqs):
        _assert_dets_equal(got[i], want[i], f"request {i}")
        _assert_dets_equal(got[i], single(r), f"request {i} alone")
    with pytest.raises(ValueError):
        fn(reqs[0])


def test_pipeline_without_nms_equals_jax(full_model):
    """with_nms=False returns the (B, 84, N) plane; the class sigmoid is
    deferred to NMS, so the class rows hold requantized pre-sigmoid
    scores."""
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    jfn, _ = jinterp.build_int_pipeline(full_model, engine="xla",
                                        with_nms=False)
    fn, _ = build_int_pipeline(full_model, "cpu", with_nms=False)
    np.testing.assert_array_equal(fn(x).numpy(),
                                  np.asarray(jax.jit(jfn)(jnp.asarray(x))))


def test_partial_quant_pipeline_matches_jax_within_f32_rounding():
    """Partial quant decodes in float (softmax, sigmoid), which differs in
    the last bits between XLA and torch: same detection count, boxes
    within 1e-3 px, scores within rtol 1e-5."""
    model, params = _model(full=False, seed=4)
    dfl = np.asarray(params["dfl"]["w"])
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    jfn, _ = jinterp.build_int_pipeline(model, dfl_w_float=dfl,
                                        engine="xla")
    det_j, n_j = jax.jit(jfn)(jnp.asarray(x))
    fn, _ = build_int_pipeline(model, "cpu", dfl_w_float=dfl)
    det_t, n_t = fn(x)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert int(n_t.sum()) > 0
    np.testing.assert_allclose(det_t[..., :4].numpy(),
                               np.asarray(det_j)[..., :4], atol=1e-3)
    np.testing.assert_allclose(det_t[..., 4].numpy(),
                               np.asarray(det_j)[..., 4], rtol=1e-5)
    np.testing.assert_array_equal(det_t[..., 5].numpy(),
                                  np.asarray(det_j)[..., 5])
    with pytest.raises(ValueError):
        build_int_pipeline(model, "cpu")


def test_collect_stats_equals_jax_within_float_rounding():
    """Float convs are not bit-identical across frameworks: rtol 1e-5."""
    cfg = QuantConfig(model="yolov8n", k=8, image_size=64)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=5)
    batches = [RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
               for _ in range(2)]
    want = jcal.collect_stats(graph, params, batches)
    got = tcal.collect_stats(graph, params, batches)
    assert set(got) == set(want)
    for tap in want:
        assert len(got[tap]) == 4
        np.testing.assert_allclose(got[tap], want[tap], rtol=1e-5,
                                   err_msg=tap)
    outs_j, _ = j_forward(graph, params, jnp.asarray(batches[0]))
    outs_t, _ = forward_float(graph, params_to_torch(params, "cpu"),
                              torch.as_tensor(batches[0]))
    for role in outs_j:
        np.testing.assert_allclose(outs_t[role].numpy(),
                                   np.asarray(outs_j[role]), rtol=1e-4,
                                   atol=1e-4, err_msg=role)


@pytest.mark.parametrize("mode", ["max", "mode", "median", "std", "n=1",
                                  "n=3", "min_mae"])
def test_reduce_stats_equals_jax(mode):
    rng = np.random.default_rng(8)
    records = {"conv_p1": rng.uniform(0, 5, 20).round(2).tolist(),
               "conv_p2": rng.uniform(0, 9, 20).round(1).tolist(),
               "start": [1.0] * 20}
    samples = {"conv_p2": rng.normal(0, 2, (4, 3, 5, 5)).astype(np.float32)}
    assert tcal.reduce_stats(records, mode, 8, samples) \
        == jcal.reduce_stats(records, mode, 8, samples)


# digest of every integer constant and fast-path flag of a QuantizedModel
_DIGEST = textwrap.dedent("""
    import hashlib
    import numpy as np

    def model_digest(m):
        h = hashlib.sha256()
        for name, c in m.convs.items():
            h.update(name.encode())
            for a in (c.w_q, c.b_q, c.r1, c.s1, c.r2, c.s2):
                if a is not None:
                    h.update(np.ascontiguousarray(a, np.int64).tobytes())
            h.update(repr((c.bigshift_ok, c.bf16_single_ok, c.bf16_offset,
                           c.req1_direct_ok, c.fold1_ok,
                           c.fold2_ok)).encode())
        hd = m.head
        h.update(repr((sorted(hd.req_fold_ok.items()),
                       sorted(hd.req_direct_ok.items()), hd.dfl_r,
                       hd.dfl_s, hd.dfl_direct_ok)).encode())
        return h.hexdigest()
""")


def test_port_runs_without_jax():
    """Building the model and running the 64-px pipeline through the port
    never loads jax (a deployment may have none), and the model built
    that way equals the one the JAX package builds."""
    code = _DIGEST + textwrap.dedent("""
        import sys
        import alpha_yolo_quant_torch
        from alpha_yolo_quant_tpu.config import QuantConfig
        from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
        from alpha_yolo_quant_tpu.models.params import init_params
        from alpha_yolo_quant_tpu.runtime.golden import golden_forward
        from alpha_yolo_quant_torch.quantize.calibrate import (
            collect_stats, reduce_stats)
        from alpha_yolo_quant_torch.quantize.transform import (
            build_quantized_model)
        from alpha_yolo_quant_torch.runtime.interpreter import (
            build_int_pipeline)
        cfg = QuantConfig(model="yolov8n", k=8, full_quant=True,
                          image_size=64)
        g = build_yolov8_graph(cfg)
        p = init_params(g, seed=0)
        x = np.random.default_rng(0).uniform(0, 1, (2, 3, 64, 64)).astype(
            np.float32)
        max_a = reduce_stats(collect_stats(g, p, [x]))
        m = build_quantized_model(g, p, max_a, cfg)
        golden_forward(m, x[:1])
        fn, _ = build_int_pipeline(m, "cpu")
        det, n = fn(x)
        assert det.shape == (2, 300, 6)
        print("MAX_A", repr(sorted(max_a.items())))
        print("DIGEST", model_digest(m))
        bad = sorted(k for k in sys.modules if k == "jax" or
                     k.startswith("jax.") or k.startswith("jaxlib"))
        print("JAX_MODULES", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "JAX_MODULES []" in res.stdout, res.stdout[-2000:]
    lines = dict(ln.split(" ", 1) for ln in res.stdout.splitlines()
                 if ln.startswith(("MAX_A", "DIGEST")))
    ns = {}
    exec(_DIGEST, ns)
    cfg = QuantConfig(model="yolov8n", k=8, full_quant=True, image_size=64)
    graph = build_yolov8_graph(cfg)
    max_a = dict(eval(lines["MAX_A"]))
    want = build_quantized_model(graph, init_params(graph, seed=0), max_a,
                                 cfg)
    assert lines["DIGEST"] == ns["model_digest"](want)


def test_port_sources_never_import_jax():
    root = os.path.join(REPO, "alpha_yolo_quant_torch")
    offenders = []
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(dirpath, f)).read()
                if "import jax" in src or "from jax" in src:
                    offenders.append(f)
    smoke = open(os.path.join(REPO, "chip_smoke.py")).read()
    assert not offenders and "import jax" not in smoke \
        and "from jax" not in smoke
