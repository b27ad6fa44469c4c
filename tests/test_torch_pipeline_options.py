"""build_int_pipeline's options against the jitted JAX pipeline at 64 px:
EngineOptions.per_image_amax, nms_params= from eval_nms_params, and the
stage-8 NMS quirks (agnostic, trunc_boxes). One JAX compile per
configuration runs every option at once; each option is also shown to
change the port's output on these inputs, so the equality covers it.
Full quant bit-exact; partial quant within the f32 tolerance of
test_partial_quant_pipeline_matches_jax_within_f32_rounding."""

import dataclasses

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from alpha_yolo_quant_tpu.runtime import interpreter as jinterp
from alpha_yolo_quant_torch.runtime.interpreter import (
    EngineOptions, build_int_pipeline, eval_nms_params, quantize_input,
)
from test_torch_model_build import build_pair

RNG = np.random.default_rng(29)
DFL = np.arange(16, dtype=np.float32)     # init_params' DFL weight
QUIRKS = dict(agnostic=True, trunc_boxes=True)


def _images(n=3, rng=RNG):
    """Images whose per-image amax differs from the pinned a=1."""
    x = rng.uniform(0, 1, (n, 3, 64, 64)).astype(np.float32)
    return x * np.float32([0.37, 0.81, 1.0][:n]).reshape(n, 1, 1, 1)


@pytest.fixture(scope="module")
def full_case():
    """yolov8n full quant, its images, the port's NMS params and the jitted
    JAX pipeline's detections, all options on at once (per_image_amax,
    eval_nms_params at 0.05, agnostic, trunc_boxes): one JAX compile
    serves every full-quant test below."""
    tmodel, jmodel = build_pair(k=8, full_quant=True, seed=11, calib_seed=3)
    x = _images(3, np.random.default_rng(41))
    jfn, _ = jinterp.build_int_pipeline(
        jmodel, engine="xla",
        nms_params=dataclasses.replace(jinterp.eval_nms_params(jmodel, 0.05),
                                       **QUIRKS),
        options=jinterp.EngineOptions(per_image_amax=True))
    det_j = jax.jit(jfn)(jnp.asarray(x))
    tp = dataclasses.replace(eval_nms_params(tmodel, 0.05), **QUIRKS)
    return tmodel, jmodel, x, tp, (np.asarray(det_j[0]), np.asarray(det_j[1]))


def _run_full(case, params=None, per_image_amax=True):
    tmodel, _, x, tp, _ = case
    fn, _ = build_int_pipeline(
        tmodel, "cpu", nms_params=tp if params is None else params,
        options=EngineOptions(per_image_amax=per_image_amax))
    return fn(x)


def _assert_dets_equal(got, want):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


def _assert_dets_close(got, want):
    det_t, n_t = got
    det_j = np.asarray(want[0])
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(det_t[..., :4].numpy(), det_j[..., :4],
                               atol=1e-3)
    np.testing.assert_allclose(det_t[..., 4].numpy(), det_j[..., 4],
                               rtol=1e-5)
    np.testing.assert_array_equal(det_t[..., 5].numpy(), det_j[..., 5])


def test_quantize_input_per_image_amax_equals_jax():
    """s = qmax / a as a division of two tensors meets JAX's ties; uint8
    normalised by an IEEE u/255 (eager JAX divides too)."""
    x = _images(3)
    x[1, 0, 0, :4] = [0.5 * 0.81, -0.81, 0.25, 0.81]   # ties and extremes
    u = RNG.integers(0, 256, (2, 3, 16, 16)).astype(np.uint8)
    u[1] = np.minimum(u[1], 200)
    for k in (8, 4):
        for inp in (x, u):
            want = np.asarray(jinterp.quantize_input(
                jnp.asarray(inp), k, per_image_amax=True))
            got = quantize_input(torch.as_tensor(inp), k,
                                 per_image_amax=True)
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), want)


def test_per_image_amax_pipeline_equals_jax(full_case):
    got = _run_full(full_case)
    assert int(got[1].sum()) > 0
    _assert_dets_equal(got, full_case[4])
    pinned = _run_full(full_case, per_image_amax=False)
    assert not torch.equal(pinned[0], got[0])


def _assert_each_quirk_changes(fn_of_params, params, got, quirks):
    for q in quirks:
        other = fn_of_params(dataclasses.replace(params, **{q: False}))
        assert not (torch.equal(other[0], got[0])
                    and torch.equal(other[1], got[1])), q


def test_eval_nms_params_with_quirks_equal_jax(full_case):
    """Full quant: the mAP protocol's quantized NMS params at a float
    threshold (moved to the pre-sigmoid domain inside the pipeline) with
    agnostic NMS and truncated boxes. Agnostic changes this output;
    truncation cannot, because full-quant boxes are whole anchor units."""
    tmodel, jmodel, _, tp, det_j = full_case
    plain_tp = eval_nms_params(tmodel, 0.05)
    assert dataclasses.asdict(plain_tp) == {
        f: v for f, v in dataclasses.asdict(
            jinterp.eval_nms_params(jmodel, 0.05)).items()
        if f in dataclasses.asdict(plain_tp)}

    def run(params):
        return _run_full(full_case, params)

    got = run(tp)
    assert int(got[1].sum()) > 0
    _assert_dets_equal(got, det_j)
    _assert_each_quirk_changes(run, tp, got, ["agnostic"])
    same = run(dataclasses.replace(tp, trunc_boxes=False))
    assert torch.equal(same[0], got[0]) and torch.equal(same[1], got[1])


def test_partial_quant_eval_nms_params_with_quirks_match_jax():
    """Partial quant: float NMS params from eval_nms_params, agnostic and
    truncated pixel boxes; each quirk changes this output."""
    tmodel, jmodel = build_pair(k=8, full_quant=False, seed=10,
                                calib_seed=4)
    x = _images(2)
    jfn, _ = jinterp.build_int_pipeline(
        jmodel, dfl_w_float=DFL, engine="xla",
        nms_params=dataclasses.replace(jinterp.eval_nms_params(jmodel, 0.01),
                                       **QUIRKS))
    tp = eval_nms_params(tmodel, 0.01)
    assert (tp.conf_thres, tp.pre_topk, tp.quantized) == (0.01, 1000, False)
    tp = dataclasses.replace(tp, **QUIRKS)

    def run(params):
        return build_int_pipeline(tmodel, "cpu", dfl_w_float=DFL,
                                  nms_params=params)[0](x)

    got = run(tp)
    assert int(got[1].sum()) > 0
    _assert_dets_close(got, jax.jit(jfn)(jnp.asarray(x)))
    _assert_each_quirk_changes(run, tp, got, ["agnostic", "trunc_boxes"])
