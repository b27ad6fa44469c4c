"""The port's ``pallas`` and ``packed`` engines (int_forward(engine=...),
their kernels' plain versions on the CPU) against the JAX package's
int_forward(engine="xla") on every head edge, at the 64-px scale:
K=8 and K=4, the saturated-concat model, and the hybrid allow= slab plans.
Bit-exact (tolerance 0). JAX's own tests hold its engines equal to xla."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from alpha_yolo_quant_tpu.runtime import interpreter as jinterp
from alpha_yolo_quant_torch.runtime.interpreter import (
    build_int_pipeline, device_plan, int_forward, quantize_input,
)
from alpha_yolo_quant_torch.runtime.slabforward import build_slab_plan
from test_torch_model_build import build_pair

RNG = np.random.default_rng(11)


def _jax_heads(jmodel, x):
    plan = jinterp.device_plan(jmodel)
    fn = jax.jit(lambda xx: jinterp.int_forward(
        jmodel, plan, jinterp.quantize_input(xx, jmodel.cfg.k),
        engine="xla"))
    return {r: np.asarray(v) for r, v in fn(jnp.asarray(x)).items()}


def _assert_heads(model, got, want, msg):
    for role in model.graph.outputs:
        assert got[role].dtype == torch.int32
        np.testing.assert_array_equal(got[role].numpy(), want[role],
                                      err_msg=f"{msg} {role}")


def _port_heads(model, x, engine, plan=None):
    plan = plan if plan is not None else device_plan(model, "cpu")
    return int_forward(model, plan, quantize_input(torch.as_tensor(x),
                                                   model.cfg.k),
                       engine=engine)


@pytest.mark.parametrize("k", [8, 4])
def test_engines_equal_jax_xla(k):
    tmodel, jmodel = build_pair(k=k, full_quant=True, seed=2, calib_seed=k)
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    want = _jax_heads(jmodel, x)
    plan = device_plan(tmodel, "cpu")
    for engine in ("pallas", "packed"):
        _assert_heads(tmodel, _port_heads(tmodel, x, engine, plan), want,
                      f"{engine} k={k}")
    assert plan["slabplan"].n_convs > 30


def test_engines_exact_with_saturated_concat_edges():
    """Chained-residual concat edges carrying |x| up to 3*qmax = 381: the
    pallas engine's nibble split reaches [-24, 23] in its high part, the
    packed engine packs them as three int8 part slabs."""
    def tamper(graph, max_a):
        t = dict(max_a)
        for name in ("C2F_4_conv_0", "C2F_6_conv_0"):
            t[graph.conv_by_name(name).out_tap] *= 0.05
        return t

    tmodel, jmodel = build_pair(k=8, full_quant=False, seed=2,
                                tamper=tamper)
    wide = [e for e, a in tmodel.edge_amax_int.items() if a > 254]
    assert wide, "plan must declare 381-wide edges"
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    env = int_forward(tmodel, device_plan(tmodel, "cpu"), quantize_input(
        torch.as_tensor(x), 8), keep_env=True)["__env__"]
    assert max(int(env[e].abs().max()) for e in wide) > 254, \
        "test data must exceed the two-part range"
    want = _jax_heads(jmodel, x)
    for engine in ("pallas", "packed"):
        _assert_heads(tmodel, _port_heads(tmodel, x, engine), want,
                      f"{engine} saturated")


def test_hybrid_filtered_slab_plans_equal_jax_xla():
    """build_slab_plan(allow=) hybrids: filtered convs leave the slab
    region with boundary unpacks, and the mixed forward stays exact."""
    tmodel, jmodel = build_pair(k=8, full_quant=False, seed=2)
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    want = _jax_heads(jmodel, x)
    full = build_slab_plan(tmodel)
    for name, pred in (("h>=32", lambda n, c, h, w: h >= 32),
                       ("16..32", lambda n, c, h, w: 16 <= h <= 32)):
        plan = device_plan(tmodel, "cpu")
        plan["slabplan"] = sp = build_slab_plan(tmodel, allow=pred)
        assert 0 < len(sp.nodes) < len(full.nodes), name
        _assert_heads(tmodel, _port_heads(tmodel, x, "packed", plan), want,
                      f"hybrid {name}")


def test_engine_choices_and_pipeline():
    """keep_env and the plain path stay on fused; other engines and names
    raise. The pipeline on each engine gives the fused detections."""
    tmodel, _ = build_pair(k=8, full_quant=True, seed=2)
    plan = device_plan(tmodel, "cpu")
    xq = quantize_input(torch.zeros((1, 3, 64, 64)), 8)
    for kw in (dict(engine="xla"), dict(engine="pallas", keep_env=True),
               dict(engine="packed", plain=True)):
        with pytest.raises(ValueError):
            int_forward(tmodel, plan, xq, **kw)
    with pytest.raises(ValueError):
        build_int_pipeline(tmodel, "cpu", engine="packed", plain=True)
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    det, n = build_int_pipeline(tmodel, "cpu")[0](x)
    assert int(n.sum()) > 0
    for engine in ("pallas", "packed"):
        det_e, n_e = build_int_pipeline(tmodel, "cpu", engine=engine)[0](x)
        assert torch.equal(det_e, det) and torch.equal(n_e, n), engine
