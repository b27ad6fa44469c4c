"""The PyTorch port's serving pipeline and calibration against the JAX
package at the 64-px scale, and the port's independence from JAX and from
the JAX package."""

import ast
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
from alpha_yolo_quant_torch.config import QuantConfig as TConfig
from alpha_yolo_quant_torch.models.forward import forward_float
from alpha_yolo_quant_torch.models.graph import (
    build_yolov8_graph as t_build_graph,
)
from alpha_yolo_quant_torch.models.params import params_to_torch
from alpha_yolo_quant_torch.quantize import calibrate as tcal
from alpha_yolo_quant_torch.runtime.interpreter import build_int_pipeline
from test_torch_model_build import build_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RNG = np.random.default_rng(17)


def _model(full=True, k=8, seed=3):
    """(port model, JAX model) from the same params and calibration."""
    return build_pair(k=k, full_quant=full, seed=seed,
                      calib_seed=int(RNG.integers(1 << 30)))


@pytest.fixture(scope="module")
def full_model():
    return _model()


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
    tmodel, jmodel = full_model
    jfn, _ = jinterp.build_int_pipeline(jmodel, engine="xla")
    want = jax.jit(jfn)(jnp.asarray(x))
    fn, _ = build_int_pipeline(tmodel, "cpu")
    got = fn(x)
    assert int(got[1].sum()) > 0, "test input must produce detections"
    _assert_dets_equal(got, want, dtype)


def test_pipeline_coalesce_requests_equals_jax(full_model):
    reqs = [RNG.integers(0, 256, (2, 3, 64, 64)).astype(np.uint8),
            RNG.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32),
            RNG.uniform(0, 1, (3, 3, 64, 64)).astype(np.float32)]
    tmodel, jmodel = full_model
    jfn, _ = jinterp.build_int_pipeline(jmodel, engine="xla",
                                        coalesce_requests=3)
    want = jax.jit(jfn)(*[jnp.asarray(r) for r in reqs])
    fn, _ = build_int_pipeline(tmodel, "cpu", coalesce_requests=3)
    got = fn(*reqs)
    assert len(got) == 3
    single, _ = build_int_pipeline(tmodel, "cpu")
    for i, r in enumerate(reqs):
        _assert_dets_equal(got[i], want[i], f"request {i}")
        _assert_dets_equal(got[i], single(r), f"request {i} alone")
    with pytest.raises(ValueError):
        fn(reqs[0])


def test_pipeline_without_nms_equals_jax(full_model):
    """with_nms=False returns the (B, 84, N) plane; the class sigmoid is
    deferred to NMS, so the class rows hold requantized pre-sigmoid
    scores."""
    tmodel, jmodel = full_model
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    jfn, _ = jinterp.build_int_pipeline(jmodel, engine="xla",
                                        with_nms=False)
    fn, _ = build_int_pipeline(tmodel, "cpu", with_nms=False)
    np.testing.assert_array_equal(fn(x).numpy(),
                                  np.asarray(jax.jit(jfn)(jnp.asarray(x))))


def test_partial_quant_pipeline_matches_jax_within_f32_rounding():
    """Partial quant decodes in float (softmax, sigmoid), which differs in
    the last bits between XLA and torch: same detection count, boxes
    within 1e-3 px, scores within rtol 1e-5."""
    model, jmodel = _model(full=False, seed=4)
    dfl = np.arange(16, dtype=np.float32)     # init_params' DFL weight
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    jfn, _ = jinterp.build_int_pipeline(jmodel, dfl_w_float=dfl,
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
    tgraph = t_build_graph(TConfig(model="yolov8n", k=8, image_size=64))
    params = init_params(graph, seed=5)
    batches = [RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
               for _ in range(2)]
    want = jcal.collect_stats(graph, params, batches)
    got = tcal.collect_stats(tgraph, params, batches, "cpu")
    assert set(got) == set(want)
    for tap in want:
        assert len(got[tap]) == 4
        np.testing.assert_allclose(got[tap], want[tap], rtol=1e-5,
                                   err_msg=tap)
    outs_j, _ = j_forward(graph, params, jnp.asarray(batches[0]))
    outs_t, _ = forward_float(tgraph, params_to_torch(params, "cpu"),
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
    """Building the model (graph, params, calibration, quantize), running
    the 64-px pipeline and golden oracle, exporting the artifact tree and
    loading it back through the port, running the CLI's memsim and info,
    and importing the CLI, eval, export, prefetch, hwsim, profiling,
    bench and parallel modules never loads jax or any module of the JAX
    package (a deployment may have neither), and the model built that way
    equals the one the JAX package builds."""
    code = _DIGEST + textwrap.dedent("""
        import os
        import sys
        import tempfile
        import alpha_yolo_quant_torch
        import alpha_yolo_quant_torch.cli
        import alpha_yolo_quant_torch.data.prefetch
        import alpha_yolo_quant_torch.eval.harness
        import alpha_yolo_quant_torch.eval.map_oracle
        import alpha_yolo_quant_torch.eval.metrics
        import alpha_yolo_quant_torch.eval.plots
        import alpha_yolo_quant_torch.utils.debug_dump
        import alpha_yolo_quant_torch.utils.run_log
        import alpha_yolo_quant_torch.bench
        import alpha_yolo_quant_torch.hwsim.refmem
        import alpha_yolo_quant_torch.hwsim.sram
        import alpha_yolo_quant_torch.utils.profiling
        import alpha_yolo_quant_torch.parallel.dryrun
        import alpha_yolo_quant_torch.parallel.mesh
        import alpha_yolo_quant_torch.parallel.pipeline
        from alpha_yolo_quant_torch.export.artifacts import export_all
        from alpha_yolo_quant_torch.quantize.loadq import (
            model_from_packed_state_dict)
        from alpha_yolo_quant_torch.config import QuantConfig
        from alpha_yolo_quant_torch.models.graph import build_yolov8_graph
        from alpha_yolo_quant_torch.models.params import init_params
        from alpha_yolo_quant_torch.runtime.golden import golden_forward
        from alpha_yolo_quant_torch.quantize.calibrate import (
            collect_stats, reduce_stats)
        from alpha_yolo_quant_torch.quantize.transform import (
            build_quantized_model)
        from alpha_yolo_quant_torch.runtime.interpreter import (
            build_int_pipeline, device_plan, int_forward, quantize_input)
        import torch
        cfg = QuantConfig(model="yolov8n", k=8, full_quant=True,
                          image_size=64)
        g = build_yolov8_graph(cfg)
        p = init_params(g, seed=0)
        x = np.random.default_rng(0).uniform(0, 1, (2, 3, 64, 64)).astype(
            np.float32)
        max_a = reduce_stats(collect_stats(g, p, [x], "cpu"))
        m = build_quantized_model(g, p, max_a, cfg)
        env = golden_forward(m, x[:1])
        outs = int_forward(m, device_plan(m, "cpu"),
                           quantize_input(torch.as_tensor(x[:1]), 8))
        for role in g.outputs:
            assert np.array_equal(outs[role].numpy(), env[role])
        fn, _ = build_int_pipeline(m, "cpu")
        det, n = fn(x)
        assert det.shape == (2, 300, 6)
        with tempfile.TemporaryDirectory() as tmp:
            export_all(m, env, p, tmp, warn=lambda *a: None)
            m2 = model_from_packed_state_dict(tmp, cfg)
        assert model_digest(m2) == model_digest(m)
        with tempfile.TemporaryDirectory() as tmp:
            assert alpha_yolo_quant_torch.cli.main(
                ["memsim", "--image-size", "64", "--out", tmp]) in (0, None)
            assert os.path.isfile(os.path.join(tmp, "results",
                                               "final_memory.txt"))
        assert alpha_yolo_quant_torch.cli.main(
            ["info", "--image-size", "64"]) in (0, None)
        print("MAX_A", repr(sorted(max_a.items())))
        print("DIGEST", model_digest(m))
        bad = sorted(k for k in sys.modules if k == "jax" or
                     k.startswith(("jax.", "jaxlib", "alpha_yolo_quant_tpu")))
        print("FORBIDDEN_MODULES", bad)
    """)
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "FORBIDDEN_MODULES []" in res.stdout, res.stdout[-2000:]
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


def _imported_roots(path):
    """Top-level package of every import statement in a Python file (the
    AST, so comments and strings do not count)."""
    roots = set()
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_sources_never_import_jax():
    """No module of the port and no line of chip_smoke.py imports jax or
    the JAX package."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO,
                                                  "alpha_yolo_quant_torch")):
        files += [os.path.join(dirpath, f) for f in names
                  if f.endswith(".py")]
    assert len(files) > 20
    forbidden = {"jax", "jaxlib", "alpha_yolo_quant_tpu"}
    offenders = {os.path.relpath(f, REPO): sorted(_imported_roots(f)
                                                  & forbidden)
                 for f in files}
    assert not {f: r for f, r in offenders.items() if r}
    assert "torch" in _imported_roots(os.path.join(
        REPO, "alpha_yolo_quant_torch", "runtime", "interpreter.py"))
