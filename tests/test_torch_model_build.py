"""The PyTorch port's own copies of the host-side modules (config, graph
IR, params, quantize primitives/LUTs/transform, golden oracle) against the
JAX package's, on the same numpy inputs. Equal field by field, tolerance
0 (NaN equals NaN: the plain head edges carry a NaN scale)."""

import dataclasses

import numpy as np
import pytest

import conftest  # noqa: F401

from alpha_yolo_quant_tpu.config import QuantConfig as JConfig
from alpha_yolo_quant_tpu.models import graph as jgraph
from alpha_yolo_quant_tpu.models import params as jparams
from alpha_yolo_quant_tpu.quantize import luts as jluts
from alpha_yolo_quant_tpu.quantize import primitives as jprim
from alpha_yolo_quant_tpu.quantize.transform import (
    build_quantized_model as j_build,
)
from alpha_yolo_quant_tpu.runtime import golden as jgolden
from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.models import graph as tgraph
from alpha_yolo_quant_torch.models import params as tparams
from alpha_yolo_quant_torch.quantize import luts as tluts
from alpha_yolo_quant_torch.quantize import primitives as tprim
from alpha_yolo_quant_torch.quantize.calibrate import (
    collect_stats, reduce_stats,
)
from alpha_yolo_quant_torch.quantize.transform import build_quantized_model
from alpha_yolo_quant_torch.runtime import golden as tgolden

RNG = np.random.default_rng(31)


def assert_same(a, b, path="model"):
    """Deep equality of the two packages' objects: dataclasses by class
    name and fields, dicts by keys, arrays by dtype and values."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name),
                        f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, (np.ndarray, np.generic)):
        assert isinstance(b, (np.ndarray, np.generic)), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float):
        assert isinstance(b, float) and (a == b or (a != a and b != b)), \
            f"{path}: {a} != {b}"
    else:
        assert type(a) is type(b) and a == b, f"{path}: {a!r} != {b!r}"


@pytest.fixture
def one_torch_thread():
    """One intra-op torch thread for the test. The 64-px workloads gain
    nothing from more, and the suite runs several workers on one CPU:
    torch's default of a thread per core in each worker oversubscribes
    the cores many times over (a test of 4 s alone took 100 s inside the
    6-worker run)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def build_pair(model="yolov8n", k=8, full_quant=True, size=64, seed=0,
               calib_seed=0, tamper=None):
    """(port model, JAX model) built by each package's own modules from
    the same numpy params and calibration (the port's collect_stats on
    the CPU)."""
    cfg = QuantConfig(model=model, k=k, full_quant=full_quant,
                      image_size=size)
    graph = tgraph.build_yolov8_graph(cfg)
    params = tparams.init_params(graph, seed=seed)
    calib = np.random.default_rng(calib_seed).uniform(
        0, 1, (2, 3, size, size)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib], "cpu"),
                         "max", k)
    if tamper:
        max_a = tamper(graph, max_a)
    jcfg = JConfig(model=model, k=k, full_quant=full_quant, image_size=size)
    jmodel = j_build(jgraph.build_yolov8_graph(jcfg), params, max_a, jcfg)
    return build_quantized_model(graph, params, max_a, cfg), jmodel


@pytest.mark.parametrize("model", ["yolov8n", "yolov8s", "yolov8m"])
def test_graph_equals_jax(model):
    for full in (False, True):
        tg = tgraph.build_yolov8_graph(QuantConfig(
            model=model, full_quant=full, image_size=640))
        jg = jgraph.build_yolov8_graph(JConfig(
            model=model, full_quant=full, image_size=640))
        assert len(tg.nodes) == len(jg.nodes) > 60
        assert_same(tg, jg, f"{model} graph")
        assert tg.cfg.qmax == jg.cfg.qmax
        assert tg.cfg.sigmoid_lut_domain == jg.cfg.sigmoid_lut_domain


def test_params_and_slots_equal_jax():
    """init_params is what carries weights across: the same seed gives
    the same arrays. The checkpoint slot order and its loader agree."""
    cfg = QuantConfig(model="yolov8n", image_size=64)
    jcfg = JConfig(model="yolov8n", image_size=64)
    tg, jg = tgraph.build_yolov8_graph(cfg), jgraph.build_yolov8_graph(jcfg)
    for seed in (0, 3):
        assert_same(tparams.init_params(tg, seed),
                    jparams.init_params(jg, seed), f"params seed {seed}")
    slots = tparams.raw_param_slots(tg)
    assert slots == jparams.raw_param_slots(jg)
    values = []
    for key, fields in slots:
        node = None if key == "dfl" else next(n for n in tg.convs()
                                              if n.key == key)
        for f in fields:
            shape = ((1, 16, 1, 1) if node is None else
                     tparams._slot_shape(node, f))
            values.append(RNG.normal(size=shape).astype(np.float32))
    assert_same(tparams.load_raw_from_values(tg, values),
                jparams.load_raw_from_values(jg, values), "raw")
    with pytest.raises(ValueError):
        tparams.load_raw_from_values(tg, values[:-1])


def test_primitives_and_luts_equal_jax():
    for k in (2, 4, 8):
        w = RNG.normal(0, 0.3, (6, 5, 3, 3)).astype(np.float32)
        assert_same(tprim.quant_matrix(w, k), jprim.quant_matrix(w, k))
        old = np.exp(RNG.uniform(np.log(2.0), np.log(5e4), (1, 6, 1, 1)))
        new = float(np.exp(RNG.uniform(np.log(0.5), np.log(50.0))))
        assert_same(tprim.derive_rescale_shift(old, new),
                    jprim.derive_rescale_shift(old, new))
        x = RNG.integers(-(2 ** 24), 2 ** 24, (3, 6, 5, 5))
        assert_same(tprim.requantize_np(x, old, new, k),
                    jprim.requantize_np(x, old, new, k))
        b = RNG.normal(0, 0.1, 6)
        assert_same(tprim.quant_bias(b, old.reshape(-1)),
                    jprim.quant_bias(b, old.reshape(-1)))
    for ctor, args in (("sigmoid_lut", (6.0, 8)), ("sigmoid_lut", (7.0, 4)),
                       ("sigmoid_lut", (12.0, 16)),
                       ("exponent_lut", (14.8264799118042, 8))):
        assert_same(getattr(tluts, ctor)(*args), getattr(jluts, ctor)(*args),
                    f"{ctor}{args}")


@pytest.mark.parametrize("full", [True, False], ids=["full", "partial"])
@pytest.mark.parametrize("k", [8, 4])
def test_quantized_model_equals_jax(k, full):
    """Every field: conv plans (integer weights, biases, scales, requant
    constants, fast-path flags, bounds), structural requants, edge scales
    and bounds, the residual clip, LUTs and the head constants."""
    tmodel, jmodel = build_pair(k=k, full_quant=full, seed=k)
    assert (tmodel.head is None) == (not full)
    assert_same(tmodel, jmodel, f"k={k} full={full}")


@pytest.mark.parametrize("full", [True, False], ids=["full", "partial"])
def test_golden_forward_equals_jax(full):
    tmodel, jmodel = build_pair(k=8 if full else 4, full_quant=full, seed=5)
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    got = tgolden.golden_forward(tmodel, x)
    want = jgolden.golden_forward(jmodel, x)
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    if full:
        np.testing.assert_array_equal(tgolden.decode_full_quant_np(tmodel,
                                                                   got),
                                      jgolden.decode_full_quant_np(jmodel,
                                                                   want))
    else:
        np.testing.assert_array_equal(tgolden.decode_partial_np(tmodel, got),
                                      jgolden.decode_partial_np(jmodel, want))
