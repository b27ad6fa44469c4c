"""The conf-first sparse decode (interpreter.decode_select_sparse,
build_int_pipeline(sparse_select=True)) and NMS over preselected
candidates, against the JAX package and against the port's dense path.
Bit-exact."""

import dataclasses

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from alpha_yolo_quant_tpu.postprocess import nms as jnms
from alpha_yolo_quant_tpu.runtime import interpreter as jinterp
from alpha_yolo_quant_torch.postprocess import nms as tnms
from alpha_yolo_quant_torch.runtime import interpreter as tinterp
from test_torch_model_build import build_pair, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def models():
    """(port model, JAX model): yolov8n K=8 full quant at 64 px."""
    return build_pair(k=8, full_quant=True, seed=1, calib_seed=5)


def _head_outs(size, batch, seed):
    """Random head_requant outputs at a size's shapes: int8 box bins over
    their whole range, int16 class scores spread per anchor over a few
    hundred values, so that anchors tie on their best score."""
    rng = np.random.default_rng(seed)
    outs = {}
    for level, stride in (("p3", 8), ("p4", 16), ("p5", 32)):
        hw = size // stride
        outs[f"{level}_box"] = rng.integers(-128, 128, (batch, 64, hw, hw),
                                            dtype=np.int8)
        outs[f"{level}_cls"] = (
            rng.integers(-20, 20, (batch, 80, hw, hw))
            + rng.integers(-200, 200, (batch, 1, hw, hw))).astype(np.int16)
    return outs


@pytest.mark.parametrize("size,pre_topk", [(64, 32), (160, 100)])
def test_decode_select_sparse_equals_jax(models, size, pre_topk):
    """All four outputs exactly equal to the jitted JAX function where the
    pre_topk cut bites (N = 84 at 64 px, 525 at 160 px)."""
    tmodel, jmodel = models
    outs = _head_outs(size, 3, seed=size)
    # a threshold inside the kept scores: some candidates valid, some not
    best = np.concatenate([outs[f"{lv}_cls"].max(1).reshape(3, -1)
                           for lv in ("p3", "p4", "p5")], 1)
    conf_thres = float(np.sort(best[0])[::-1][pre_topk // 2]) - 0.5
    jplan = jinterp.device_plan(jmodel)
    want = jax.jit(lambda o: jinterp.decode_select_sparse(
        jmodel, jplan, o, pre_topk=pre_topk,
        conf_thres=conf_thres))({k: jnp.asarray(v) for k, v in outs.items()})
    got = tinterp.decode_select_sparse(
        tmodel, tinterp.device_plan(tmodel, "cpu"),
        {k: torch.as_tensor(v) for k, v in outs.items()},
        pre_topk=pre_topk, conf_thres=conf_thres)
    n = sum((size // s) ** 2 for s in (8, 16, 32))
    assert pre_topk < n
    for g, w, name in zip(got, want, ("boxes", "conf", "cid", "valid")):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and w.shape[1] == pre_topk, name
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    valid = got[3].numpy()
    assert valid.any() and not valid.all()
    # ties on the best score were broken by the lowest anchor index
    conf = got[1].numpy()
    assert (conf[:, 1:] == conf[:, :-1]).any()


def _pipelines(model, **kw):
    return (tinterp.build_int_pipeline(model, "cpu", **kw)[0],
            tinterp.build_int_pipeline(model, "cpu", sparse_select=True,
                                       **kw)[0])


def _images(batch=3, seed=4):
    return np.random.default_rng(seed).uniform(
        0, 1, (batch, 3, 64, 64)).astype(np.float32)


def _assert_equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture
def sparse_calls(monkeypatch):
    """Counts the pipeline's calls of decode_select_sparse."""
    calls = []
    real = tinterp.decode_select_sparse

    def counted(*a, **kw):
        calls.append(kw["pre_topk"])
        return real(*a, **kw)

    monkeypatch.setattr(tinterp, "decode_select_sparse", counted)
    return calls


@pytest.mark.parametrize("engine", ["fused", "pallas", "packed"])
def test_sparse_pipeline_equals_dense_on_every_engine(models, engine,
                                                      sparse_calls):
    """Batch 3 through each engine's plain versions, the serving defaults
    and the mAP protocol's params; a third case cuts to the top 32 of the
    84 anchors."""
    tmodel = models[0]
    x = _images()
    params = [None, tinterp.eval_nms_params(tmodel, 0.001),
              dataclasses.replace(tinterp.eval_nms_params(tmodel, 0.001),
                                  pre_topk=32)]
    total = 0
    for nms in params:
        dense, sparse = _pipelines(tmodel, engine=engine, nms_params=nms)
        want = dense(x)
        _assert_equal(sparse(x), want)
        total += int(want[1].sum())
    assert sparse_calls == [1000, 1000, 32] and total > 0


def test_sparse_composes_with_coalescing_and_plain(models, sparse_calls):
    tmodel = models[0]
    x = _images(5, seed=6)
    dense, sparse = _pipelines(tmodel, coalesce_requests=2, plain=True)
    want = dense(x[:2], x[2:])
    got = sparse(x[:2], x[2:])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _assert_equal(g, w)
    u8 = np.round(x * 255).astype(np.uint8)
    dense, sparse = _pipelines(tmodel, pad_batch_to=8)
    _assert_equal(sparse(u8), dense(u8))
    assert len(sparse_calls) == 2


def test_ineligible_pipelines_take_the_dense_path(models, sparse_calls):
    """Partial quant and with_nms=False: sparse_select=True gives the
    dense result without calling decode_select_sparse, as in JAX."""
    tmodel = models[0]
    x = _images()
    dense, sparse = _pipelines(tmodel, with_nms=False)
    _assert_equal(sparse(x), dense(x))
    partial = build_pair(k=8, full_quant=False, seed=1, calib_seed=5)[0]
    dfl = np.arange(16, dtype=np.float32)
    dense, sparse = _pipelines(partial, dfl_w_float=dfl)
    _assert_equal(sparse(x), dense(x))
    assert sparse_calls == []


def test_preselected_nms_equals_jax():
    """One sorted candidate tuple (descending score, ties by index) through
    both packages' NMS with preselected=True, the select step skipped."""
    rng = np.random.default_rng(9)
    b, m = 3, 200
    scale = 32767.0 / 7.5
    xy = rng.uniform(100, 500, (b, m, 2))
    wh = rng.uniform(10, 80, (b, m, 2))
    boxes = np.round(np.concatenate((xy - wh / 2, xy + wh / 2), 2) * scale
                     ).astype(np.float32)
    conf = -np.sort(-rng.integers(-3000, 3000, (b, m)), axis=1).astype(
        np.float32)
    cls = rng.integers(0, 80, (b, m)).astype(np.float32)
    valid = conf > -500
    params = jnms.q_nms_params(scale, conf_thres_int=-500)
    tparams = tnms.q_nms_params(scale, conf_thres_int=-500)
    det_j, n_j = jax.jit(lambda c: jnms.non_max_suppression(
        c, params, preselected=True))(
            tuple(jnp.asarray(a) for a in (boxes, conf, cls, valid)))
    det_t, n_t = tnms.non_max_suppression(
        tuple(torch.as_tensor(a) for a in (boxes, conf, cls, valid)),
        tparams, preselected=True)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(det_t.numpy(), np.asarray(det_j))
    assert 0 < int(n_t.min()) and int(n_t.max()) < int(valid.sum(1).min())
