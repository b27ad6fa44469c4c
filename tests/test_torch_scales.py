"""yolov8m through the port's runtime at 64 px, full and partial quant (the
gate of tests/test_deeper_scales.py for the port): every engine's head
edges equal the plain path and golden_forward, and the pipeline's
detections equal the jitted JAX pipeline's (full quant bit for bit;
partial quant within the f32 tolerance of
test_partial_quant_pipeline_matches_jax_within_f32_rounding)."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from alpha_yolo_quant_tpu.runtime import interpreter as jinterp
from alpha_yolo_quant_torch.runtime.golden import golden_forward
from alpha_yolo_quant_torch.runtime.interpreter import (
    build_int_pipeline, device_plan, int_forward, quantize_input,
)
from test_torch_model_build import build_pair
from test_torch_pipeline_options import _assert_dets_close

RNG = np.random.default_rng(37)
DFL = np.arange(16, dtype=np.float32)     # init_params' DFL weight


@pytest.mark.parametrize("full", [True, False], ids=["full", "partial"])
def test_yolov8m_engines_plain_golden_and_jax(full):
    tmodel, jmodel = build_pair(model="yolov8m", full_quant=full, seed=12,
                                calib_seed=2)
    assert max(c.cout for c in tmodel.graph.convs()) == 576
    x = RNG.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    plan = device_plan(tmodel, "cpu")
    x_q = quantize_input(torch.as_tensor(x), 8)
    want = golden_forward(tmodel, x)
    plain = int_forward(tmodel, plan, x_q, plain=True)
    for engine in ("fused", "pallas", "packed"):
        outs = int_forward(tmodel, plan, x_q, engine=engine)
        for role in tmodel.graph.outputs:
            np.testing.assert_array_equal(outs[role].numpy(),
                                          plain[role].numpy(),
                                          err_msg=f"{engine} {role}")
            np.testing.assert_array_equal(
                outs[role].numpy().astype(np.int64), want[role],
                err_msg=f"{engine} {role} vs golden")
    jfn, _ = jinterp.build_int_pipeline(jmodel, dfl_w_float=DFL,
                                        engine="xla")
    det_j = jax.jit(jfn)(jnp.asarray(x))
    got = build_int_pipeline(tmodel, "cpu", dfl_w_float=DFL)[0](x)
    assert int(got[1].sum()) > 0
    if full:
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(det_j[1]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(det_j[0]))
    else:
        _assert_dets_close(got, det_j)
