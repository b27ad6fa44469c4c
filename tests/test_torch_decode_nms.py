"""The PyTorch port's head decode and NMS against the JAX package on the
same inputs. Bit-exact unless a test states its tolerance. Port functions
take the port's model, JAX functions the JAX model, both built from the
same params and calibration."""

import dataclasses

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from alpha_yolo_quant_tpu.models import head as jhead
from alpha_yolo_quant_tpu.postprocess import nms as jnms
from alpha_yolo_quant_tpu.runtime import interpreter as jinterp
from alpha_yolo_quant_tpu.runtime.golden import (
    decode_full_quant_np, golden_forward, head_intermediates_np,
)
from alpha_yolo_quant_torch.models import head as thead
from alpha_yolo_quant_torch.postprocess import nms as tnms
from alpha_yolo_quant_torch.runtime import interpreter as tinterp
from test_torch_model_build import build_pair

RNG = np.random.default_rng(5)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def full_model():
    """(port model, JAX model): yolov8n K=8 full quant at 64 px."""
    return build_pair(k=8, full_quant=True, seed=1, calib_seed=5)


@pytest.fixture(scope="module")
def head_outs(full_model):
    """Random head accumulators at the model's shapes, wide enough that
    the requants, softmax and class max see their whole ranges."""
    outs = {}
    for role in full_model[0].graph.outputs:
        level = {"p3": 8, "p4": 4, "p5": 2}[role[:2]]
        c = 64 if role.endswith("box") else 80
        outs[role] = RNG.integers(-2 ** 22, 2 ** 22, (3, c, level, level),
                                  dtype=np.int64).astype(np.int32)
    return outs


def _requant_heads(models, outs):
    tmodel, jmodel = models
    jplan = jinterp.device_plan(jmodel)
    tplan = tinterp.device_plan(tmodel, "cpu")
    pre = {}
    for role, v in outs.items():
        level, kind = role.split("_")
        qmx, dt = (127, np.int8) if kind == "box" else (2 ** 15 - 1,
                                                        np.int16)
        pre[role] = np.asarray(jinterp.requantize_i32(
            jnp.asarray(v), jplan["head"][f"{kind}_r"][level],
            jplan["head"][f"{kind}_s"][level], qmx)).astype(dt)
    return jplan, tplan, pre


def test_serving_decode_equals_jax(full_model, head_outs):
    tmodel, jmodel = full_model
    jplan, tplan, pre = _requant_heads(full_model, head_outs)
    want = jax.jit(lambda o: jinterp.decode_full_quant(
        jmodel, jplan, o, sigmoid_cls=False, reduce_cls=True,
        pre_requantized=True))({k: jnp.asarray(v) for k, v in pre.items()})
    got = tinterp.decode_serving(tmodel, tplan,
                                 {k: _t(v) for k, v in pre.items()})
    for g, w, name in zip(got, want, ("dbox", "conf", "cid")):
        assert g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("sigmoid_cls", [True, False])
def test_dense_decode_equals_jax(full_model, head_outs, sigmoid_cls):
    """The (B, 84, N) decode from raw accumulators (the port's
    requant_heads, then its plane; JAX's decode requantizes itself), f32
    dist2bbox included."""
    tmodel, jmodel = full_model
    jplan, tplan, _ = _requant_heads(full_model, head_outs)
    want = np.asarray(jinterp.decode_full_quant(
        jmodel, jplan, {k: jnp.asarray(v) for k, v in head_outs.items()},
        sigmoid_cls=sigmoid_cls))
    got = tinterp.decode_full_quant(
        tmodel, tplan, tinterp.requant_heads(
            tmodel, tplan, {k: _t(v) for k, v in head_outs.items()}),
        sigmoid_cls=sigmoid_cls).numpy()
    np.testing.assert_array_equal(got, want)


def test_dfl_probs_equal_float64_truncation(full_model, head_outs):
    """The integer floor (127*e)//sum equals the reference's float64
    truncation (golden head_intermediates_np)."""
    _, tplan, _ = _requant_heads(full_model, head_outs)
    it = head_intermediates_np(full_model[1], head_outs)
    box = torch.cat([_t(it["levels"][lv]["bq"]).reshape(3, 64, -1)
                     for lv in ("p3", "p4", "p5")], 2)
    p = tinterp._dfl_softmax_probs(box.reshape(3, 4, 16, -1), 2,
                                   tplan["head"]["exp_lut"])
    np.testing.assert_array_equal(p.permute(0, 2, 1, 3).numpy(), it["p"])


def test_conf_cid_packed_equals_jax():
    cq = RNG.integers(-2 ** 15 + 1, 2 ** 15, (2, 80, 50)).astype(np.int32)
    cq[:, 7] = cq[:, 3]                      # exact ties -> lowest class
    want = jinterp._conf_cid_packed(jnp.asarray(cq))
    got = tinterp._conf_cid_packed(_t(cq))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_decode_float_equals_jax_within_f32_rounding():
    """Float softmax/sigmoid differ in the last bits between XLA and
    torch: tolerance rtol 1e-5, atol 1e-4 (boxes are O(100) px)."""
    outs = {}
    for lv, s in (("p3", 8), ("p4", 4), ("p5", 2)):
        outs[f"{lv}_box"] = RNG.normal(0, 3, (2, 64, s, s)).astype(np.float32)
        outs[f"{lv}_cls"] = RNG.normal(0, 3, (2, 80, s, s)).astype(np.float32)
    dfl = np.arange(16, dtype=np.float32)
    want = np.asarray(jhead.decode_float(
        {k: jnp.asarray(v) for k, v in outs.items()}, jnp.asarray(dfl)))
    got = thead.decode_float({k: _t(v) for k, v in outs.items()},
                             _t(dfl)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    a_j, s_j = jhead.make_anchors([(8, 8), (4, 4), (2, 2)])
    a_t, s_t = thead.make_anchors([(8, 8), (4, 4), (2, 2)])
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_dequantize_heads_equals_jax(full_model, head_outs):
    tmodel, jmodel = full_model
    want = jinterp.dequantize_heads(jmodel, {k: jnp.asarray(v) for k, v
                                             in head_outs.items()})
    got = thead.dequantize_heads(tmodel, {k: _t(v) for k, v
                                          in head_outs.items()})
    for role in want:
        np.testing.assert_array_equal(got[role].numpy(),
                                      np.asarray(want[role]))


def test_cls_int_conf_threshold_equals_jax(full_model):
    tmodel, jmodel = full_model
    for thr in (1, 8192, 20000, 32767):
        assert tinterp.cls_int_conf_threshold(tmodel, thr) \
            == jinterp.cls_int_conf_threshold(jmodel, thr)


# ------------------------------------------------------------------ NMS

def _clusters(rng, n, quantized):
    if quantized:
        centers = rng.uniform(50000, 150000, (5, 2))
        xy = centers[rng.integers(0, 5, n)] + rng.normal(0, 8000, (n, 2))
        wh = rng.uniform(20000, 45000, (n, 2))
        return np.round(np.concatenate((xy, xy + wh), 1)), \
            rng.integers(8192, 32768, n).astype(np.float64)
    centers = rng.uniform(100, 500, (6, 2))
    xy = centers[rng.integers(0, 6, n)] + rng.normal(0, 4, (n, 2))
    wh = rng.uniform(40, 60, (n, 2))
    return np.concatenate((xy, xy + wh), 1), rng.uniform(0, 1, n)


def _greedy_np(boxes, scores, iou, plus_one, quantized):
    """Sequential greedy NMS in float32, the suppress predicate of
    nms._suppress_slice."""
    b = boxes.astype(np.float32)
    x1, y1, x2, y2 = b.T
    p1 = np.float32(plus_one)
    areas = (x2 - x1 + p1) * (y2 - y1 + p1)
    order = np.argsort(-scores, kind="stable")
    keep = []
    alive = np.ones(len(b), bool)
    for i in order:
        if not alive[i]:
            continue
        keep.append(int(i))
        w = np.maximum(np.float32(0), np.minimum(x2[i], x2) -
                       np.maximum(x1[i], x1) + p1)
        h = np.maximum(np.float32(0), np.minimum(y2[i], y2) -
                       np.maximum(y1[i], y1) + p1)
        inter = w * h
        asum = areas[i] + areas
        if quantized:
            t = inter * np.float32(tnms.quantized_iou_multiplier(iou))
            sup = t > asum - t
        else:
            sup = inter / (asum - inter) > np.float32(iou)
        alive &= ~sup
    return set(keep)


@pytest.mark.parametrize("quantized", [False, True], ids=["float", "quant"])
@pytest.mark.parametrize("iou", [0.3, 0.45, 0.6])
def test_greedy_keep_set_dense_clusters(quantized, iou):
    rng = np.random.default_rng(int(iou * 100) + quantized)
    boxes, scores = _clusters(rng, 300, quantized)
    plus_one = 412.0 if quantized else 1.0
    args = (iou, 600, plus_one, quantized)
    got = tnms._greedy_nms_mask(_t(boxes).float(), _t(scores).float(),
                                torch.ones(300, dtype=torch.bool), *args)
    want = np.asarray(jnms._greedy_nms_mask(
        jnp.asarray(boxes, jnp.float32), jnp.asarray(scores, jnp.float32),
        jnp.ones(300, bool), *args))
    np.testing.assert_array_equal(got.numpy(), want)
    assert set(np.nonzero(want)[0].tolist()) == _greedy_np(
        boxes, scores.astype(np.float32), iou, plus_one, quantized)


def test_greedy_keep_set_max_det_cap():
    rng = np.random.default_rng(9)
    n, max_det = 700, 300
    xy = rng.uniform(0, 60000, (n, 2))
    boxes = np.concatenate((xy, xy + rng.uniform(30, 200, (n, 2))), 1)
    scores = rng.uniform(0, 1, n)
    valid = scores > 0.1
    args = (0.45, max_det, 1.0, False)
    got = tnms._greedy_nms_mask(_t(boxes).float(), _t(scores).float(),
                                _t(valid), *args).numpy()
    want = np.asarray(jnms._greedy_nms_mask(
        jnp.asarray(boxes, jnp.float32), jnp.asarray(scores, jnp.float32),
        jnp.asarray(valid), *args))
    assert got.sum() == max_det
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,quirks", [
    ("float_plane", {}), ("quant_tuple", {}),
    ("float_plane", {"agnostic": True}),
    ("quant_tuple", {"agnostic": True, "trunc_boxes": True}),
    ("quant_tuple", {"trunc_boxes": True})],
    ids=["float_plane", "quant_tuple", "float_plane-agnostic",
         "quant_tuple-agnostic-trunc", "quant_tuple-trunc"])
def test_non_max_suppression_equals_jax(mode, quirks):
    """Float and q_NMS, and the stage-8 quirks (class-agnostic NMS,
    boxes truncated toward zero): each changes the kept set or the rows
    on this input."""
    rng = np.random.default_rng(3)
    b, n = 3, 400
    xy = rng.uniform(100, 500, (b, 2, n))
    wh = rng.uniform(10, 80, (b, 2, n))
    if mode == "float_plane":
        pred = np.zeros((b, 84, n), np.float32)
        pred[:, 0:2], pred[:, 2:4] = xy, wh
        pred[:, 4:] = rng.uniform(0, 1, (b, 80, n)) * rng.uniform(
            0, 0.6, (b, 1, n))
        params = jnms.NmsParams(**quirks)
        tparams = tnms.NmsParams(**quirks)
        jin, tin = jnp.asarray(pred), _t(pred)
        score_map = t_map = None
    else:
        scale = 32767.0 / 7.5
        boxes = np.round(np.concatenate((xy, wh), 1) * scale
                         ).astype(np.float32)
        conf = rng.integers(-3000, 3000, (b, n)).astype(np.float32)
        cls = rng.integers(0, 80, (b, n)).astype(np.float32)
        if quirks.get("trunc_boxes"):   # fractional, so truncation moves
            boxes = boxes + rng.uniform(-0.9, 0.9, boxes.shape).astype(
                np.float32)
        params = dataclasses.replace(
            jnms.q_nms_params(scale, conf_thres_int=-500), **quirks)
        tparams = dataclasses.replace(
            tnms.q_nms_params(scale, conf_thres_int=-500), **quirks)
        jin = (jnp.asarray(boxes), jnp.asarray(conf), jnp.asarray(cls))
        tin = (_t(boxes), _t(conf), _t(cls))

        def score_map(c):
            return jnp.asarray(c, jnp.int32) * 3 + 7

        def t_map(c):
            return c.to(torch.int32) * 3 + 7
    # compiled, as the JAX pipeline runs it: XLA descales by a float32
    # reciprocal multiply, which the port reproduces
    det_j, n_j = jax.jit(lambda p_: jnms.non_max_suppression(
        p_, params, score_map=score_map))(jin)
    det_t, n_t = tnms.non_max_suppression(tin, tparams, score_map=t_map)
    assert det_t.shape == (b, 300, 6) and det_t.dtype == torch.float32
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    assert int(n_t.min()) > 0
    np.testing.assert_array_equal(det_t.numpy(), np.asarray(det_j))
    if quirks:
        det_0, n_0 = tnms.non_max_suppression(
            tin, dataclasses.replace(tparams, agnostic=False,
                                     trunc_boxes=False), score_map=t_map)
        assert not (torch.equal(det_0, det_t) and torch.equal(n_0, n_t))


def test_sort_keys_and_box_helpers_equal_jax():
    conf = RNG.integers(-2 ** 15 + 1, 2 ** 15, (2, 300)).astype(np.int32)
    key_j = np.asarray(jnms.conf_sort_key(jnp.asarray(conf), 300))
    key_t = tnms.conf_sort_key(_t(conf), 300).numpy()
    np.testing.assert_array_equal(key_t, key_j)
    np.testing.assert_array_equal(tnms.conf_from_key(_t(key_j)).numpy(),
                                  np.asarray(jnms.conf_from_key(key_j)))
    np.testing.assert_array_equal(
        tnms.index_from_key(_t(key_j), 300).numpy(),
        np.asarray(jnms.index_from_key(key_j, 300)))
    xywh = RNG.uniform(0, 640, (5, 7, 4)).astype(np.float32)
    xyxy_t = tnms.xywh2xyxy(_t(xywh))
    np.testing.assert_array_equal(
        xyxy_t.numpy(), np.asarray(jnms.xywh2xyxy(jnp.asarray(xywh))))
    np.testing.assert_array_equal(
        tnms.scale_boxes((640, 640), xyxy_t, (480, 600)).numpy(),
        np.asarray(jnms.scale_boxes((640, 640), jnp.asarray(xyxy_t.numpy()),
                                    (480, 600))))
    assert tnms.quantized_iou_multiplier(0.45) == 2.22
    assert tnms.q_nms_params(412.1635) == tnms.NmsParams(
        **{f: getattr(jnms.q_nms_params(412.1635), f)
           for f in tnms.NmsParams.__dataclass_fields__})


def test_golden_decode_consistency(full_model):
    """The full-quant decode of a real forward equals the golden
    decode_full_quant_np (float64) exactly: its f32 boxes are sums of
    integers below 2^24 times power-of-two strides. The class plane is in
    16-bit sigmoid units."""
    tmodel, jmodel = full_model
    x = RNG.uniform(0, 1, (1, 3, 64, 64)).astype(np.float32)
    env = golden_forward(jmodel, x)
    plan = tinterp.device_plan(tmodel, "cpu")
    preds = tinterp.decode_full_quant(tmodel, plan, tinterp.requant_heads(
        tmodel, plan, {r: _t(env[r]).to(torch.int32)
                       for r in tmodel.graph.outputs}))
    assert preds.shape == (1, 84, 84) and torch.isfinite(preds).all()
    np.testing.assert_array_equal(
        preds.numpy().astype(np.float64),
        decode_full_quant_np(jmodel, env))
    assert 0 <= float(preds[:, 4:].min()) and float(preds[:, 4:].max()) \
        <= 32767
