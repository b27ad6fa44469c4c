"""The PyTorch port's int_forward against the numpy int64 oracle
golden_forward on every edge, and its head edges against the JAX
int_forward(engine="xla"), at the 64-px scale. Bit-exact."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from alpha_yolo_quant_tpu.config import QuantConfig
from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
from alpha_yolo_quant_tpu.models.params import init_params
from alpha_yolo_quant_tpu.quantize.transform import build_quantized_model
from alpha_yolo_quant_tpu.runtime import interpreter as jinterp
from alpha_yolo_quant_tpu.runtime.golden import golden_forward
from alpha_yolo_quant_torch.quantize.calibrate import (
    collect_stats, reduce_stats,
)
from alpha_yolo_quant_torch.runtime.interpreter import (
    device_plan, int_forward, quantize_input,
)

RNG = np.random.default_rng(42)


def _setup(k=8, full_quant=False, size=64, seed=0, tamper=None):
    cfg = QuantConfig(model="yolov8n", k=k, full_quant=full_quant,
                      image_size=size)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=seed)
    calib = RNG.uniform(0, 1, (2, 3, size, size)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib]), "max", k)
    if tamper:
        max_a = tamper(graph, max_a)
    return build_quantized_model(graph, params, max_a, cfg)


def _port_env(model, x, head_requant=False):
    plan = device_plan(model, "cpu")
    got = int_forward(model, plan, quantize_input(torch.as_tensor(x),
                                                  model.cfg.k),
                      keep_env=True, head_requant=head_requant)
    return got, got.pop("__env__")


def _assert_env_equals_golden(model, env, want_env, msg):
    mismatches, compared = [], 0
    for name, w in want_env.items():
        assert name in env, f"{msg}: port env lacks {name}"
        g = env[name].numpy().astype(np.int64)
        compared += 1
        if not np.array_equal(g, np.asarray(w)):
            d = np.abs(g - np.asarray(w))
            mismatches.append((name, int(d.max()), int((d > 0).sum())))
    assert not mismatches, f"{msg}: {mismatches[:8]}"
    assert compared == len(want_env)


def _jax_heads(model, x, head_requant=False):
    plan = jinterp.device_plan(model)
    fn = jax.jit(lambda xx: jinterp.int_forward(
        model, plan, jinterp.quantize_input(xx, model.cfg.k),
        engine="xla", head_requant=head_requant))
    return {r: np.asarray(v) for r, v in fn(jnp.asarray(x)).items()}


@pytest.mark.parametrize("full", [False, True], ids=["partial", "full"])
@pytest.mark.parametrize("k", [8, 6, 4, 2])
def test_int_forward_equals_golden_and_jax(k, full):
    model = _setup(k=k, full_quant=full)
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    outs, env = _port_env(model, x)
    _assert_env_equals_golden(model, env, golden_forward(model, x),
                              f"k={k} full={full}")
    want = _jax_heads(model, x)
    for role in model.graph.outputs:
        assert outs[role].dtype == torch.int32
        np.testing.assert_array_equal(outs[role].numpy(), want[role],
                                      err_msg=role)


def test_head_requant_equals_jax():
    model = _setup(full_quant=True)
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    outs, _ = _port_env(model, x, head_requant=True)
    want = _jax_heads(model, x, head_requant=True)
    for role in model.graph.outputs:
        assert str(outs[role].dtype).split(".")[-1] == str(want[role].dtype)
        np.testing.assert_array_equal(outs[role].numpy(), want[role],
                                      err_msg=role)


def test_wide_edges_exact_with_saturated_concats():
    """Chained-residual concat edges carrying |x| up to 3*qmax = 381 (int16
    storage, the kernels' wide path) stay exact on every edge."""
    def tamper(graph, max_a):
        t = dict(max_a)
        for name in ("C2F_4_conv_0", "C2F_6_conv_0"):
            t[graph.conv_by_name(name).out_tap] *= 0.05
        return t

    model = _setup(tamper=tamper, seed=2)
    wide = [e for e, a in model.edge_amax_int.items() if a > 254]
    assert wide, "plan must declare 381-wide edges"
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    outs, env = _port_env(model, x)
    observed = max(int(env[e].abs().max()) for e in wide)
    assert observed > 254, "test data must exceed the int8 range"
    assert all(env[e].dtype == torch.int16 for e in wide)
    _assert_env_equals_golden(model, env, golden_forward(model, x),
                              "saturated")
    want = _jax_heads(model, x)
    for role in model.graph.outputs:
        np.testing.assert_array_equal(outs[role].numpy(), want[role])


def test_quantize_input_equals_jax():
    x = RNG.uniform(-0.2, 1.2, (3, 3, 16, 16)).astype(np.float32)
    u = RNG.integers(0, 256, (3, 3, 16, 16)).astype(np.uint8)
    for k in (8, 4):
        for inp in (x, u):
            want = np.asarray(jinterp.quantize_input(jnp.asarray(inp), k))
            got = quantize_input(torch.as_tensor(inp), k)
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), want)
