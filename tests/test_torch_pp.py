"""The port's pipeline parallelism (parallel/pipeline.py) and int_forward's
segment seam against the JAX package at 64 px, on the CPU.

- the stage cuts, the live boundary edges and the pipeline spec (edges,
  shapes, buffer width) equal JAX's for S in {2, 3, 4, 8}. The dtypes are
  compared with the port's own stored edges instead: JAX plans its
  pipeline on the ``auto`` engine (bf16 and int32 edges), the port on the
  fused engine (int8/int16/int32);
- an S=8 chain of segments in one process equals the unsharded int_forward
  and JAX's jitted head edges bit for bit;
- four gloo ranks, spawned once for the module: pp S=2 and S=4 and a 2x2
  dp x pp mesh give the same head edges bit for bit; build_pp_pipeline's
  full- and partial-quant detections equal the single-rank ones; the batch
  guard raises JAX's error.
"""

import numpy as np
import pytest
import torch

import conftest  # noqa: F401

import jax
import jax.numpy as jnp

import _torch_ranks
from alpha_yolo_quant_tpu.parallel import pipeline as jpp
from alpha_yolo_quant_tpu.runtime import interpreter as jinterp
from alpha_yolo_quant_torch.parallel import pipeline as tpp
from alpha_yolo_quant_torch.parallel.mesh import run_ranks
from alpha_yolo_quant_torch.postprocess.nms import (
    non_max_suppression, q_nms_params,
)
from alpha_yolo_quant_torch.runtime.interpreter import (
    build_int_pipeline, decode_full_quant, device_plan, int_forward,
    quantize_input, requant_heads,
)
from test_torch_model_build import build_pair, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

IMAGES = np.random.default_rng(29).uniform(
    0, 1, (4, 3, 64, 64)).astype(np.float32)
DFL = np.arange(16, dtype=np.float32)      # init_params' DFL weight


@pytest.fixture(scope="module")
def models():
    """{"full": (port, JAX), "partial": (port, JAX)} from one seed."""
    return {"full": build_pair(full_quant=True, seed=3, calib_seed=5),
            "partial": build_pair(full_quant=False, seed=3, calib_seed=5)}


@pytest.fixture(scope="module")
def jax_heads(models):
    """JAX's head edges of IMAGES, the module's one jitted JAX program."""
    jmodel = models["full"][1]
    jplan = jinterp.device_plan(jmodel)
    out = jax.jit(lambda x: jinterp.int_forward(
        jmodel, jplan, jinterp.quantize_input(x, 8), engine="xla"))(
            jnp.asarray(IMAGES))
    return {r: np.asarray(v) for r, v in out.items()}


@pytest.fixture(scope="module")
def port_heads(models):
    tmodel = models["full"][0]
    plan = device_plan(tmodel, "cpu")
    return plan, int_forward(tmodel, plan,
                             quantize_input(torch.as_tensor(IMAGES), 8))


@pytest.fixture(scope="module")
def ranks(models):
    """Every multi-rank result of tests/_torch_ranks.pp_checks, from one
    spawn of four gloo ranks."""
    return run_ranks(_torch_ranks.pp_checks,
                     (models["full"][0], models["partial"][0], DFL, IMAGES),
                     4, "gloo", deadline_s=300)


def _assert_heads(got, port_heads, jax_heads):
    _, want = port_heads
    assert sorted(got) == sorted(want)
    for role in want:
        np.testing.assert_array_equal(got[role], want[role].numpy(), role)
        np.testing.assert_array_equal(got[role], jax_heads[role], role)


@pytest.mark.parametrize("n_stages", [2, 3, 4, 8])
def test_cuts_live_edges_and_spec_equal_jax(models, n_stages):
    tmodel, jmodel = models["full"]
    bounds = tpp._choose_cuts(tmodel.graph, 64, n_stages)
    assert bounds == jpp._choose_cuts(jmodel.graph, 64, n_stages)
    assert bounds[0] == 0 and bounds[-1] == len(tmodel.graph.nodes)
    assert all(b < a for b, a in zip(bounds, bounds[1:]))
    for cut in bounds[1:-1]:
        live = tpp._live_edges(tmodel.graph, cut)
        assert live and live == jpp._live_edges(jmodel.graph, cut)
    spec = tpp.build_pipeline_spec(tmodel, n_stages, 2, 3)
    jspec = jpp.build_pipeline_spec(jmodel, jinterp.device_plan(jmodel),
                                    n_stages, 2, 3, engine="xla")
    assert spec.boundaries == jspec.boundaries
    assert spec.stage_in_edges == jspec.stage_in_edges
    assert spec.stage_out_edges == jspec.stage_out_edges
    assert spec.buf_width == jspec.buf_width
    assert {e: s for e, (s, _) in spec.edge_specs.items()} == \
        {e: s for e, (s, _) in jspec.edge_specs.items()}
    assert (spec.microbatch, spec.n_microbatches, spec.n_stages) == \
        (2, 3, n_stages)


def test_spec_dtypes_are_the_stored_edges(models):
    tmodel = models["full"][0]
    plan = device_plan(tmodel, "cpu")
    env = int_forward(tmodel, plan, quantize_input(
        torch.as_tensor(IMAGES[:2]), 8), keep_env=True)["__env__"]
    spec = tpp.build_pipeline_spec(tmodel, 8, 2, 1)
    for e, (shape, dt) in spec.edge_specs.items():
        assert env[e].dtype == dt and tuple(env[e].shape) == shape, e
    assert any(dt == torch.int16 for _, dt in spec.edge_specs.values())


def test_pack_unpack_round_trip_is_exact(models):
    tmodel = models["full"][0]
    spec = tpp.build_pipeline_spec(tmodel, 4, 1, 1)
    g = torch.Generator().manual_seed(0)
    edges = spec.stage_out_edges[1]
    env = {}
    for e in edges:
        shape, dt = spec.edge_specs[e]
        lim = {torch.int8: 127, torch.int16: 381}.get(dt, 2 ** 31 - 1)
        env[e] = torch.randint(-lim, lim + 1, shape, generator=g).to(dt)
    buf = tpp._pack([env[e] for e in edges], spec.buf_width)
    assert buf.dtype == torch.int32 and buf.shape == (spec.buf_width,)
    back = tpp._unpack(buf, edges, spec.edge_specs)
    for e in edges:
        assert back[e].dtype == env[e].dtype and torch.equal(back[e], env[e])


def test_segment_chain_of_eight_equals_whole_graph_and_jax(
        models, port_heads, jax_heads):
    tmodel = models["full"][0]
    plan, _ = port_heads
    spec = tpp.build_pipeline_spec(tmodel, 8, 4, 1)
    env = {tmodel.graph.input_edge: quantize_input(torch.as_tensor(IMAGES),
                                                   8)}
    for s in range(8):
        env.update(int_forward(
            tmodel, plan, None, env_in={e: env[e]
                                        for e in spec.stage_in_edges[s]},
            node_range=spec.boundaries[s:s + 2],
            out_edges=spec.stage_out_edges[s]))
    got = {r: env[e].numpy() for r, e in tmodel.graph.outputs.items()}
    _assert_heads(got, port_heads, jax_heads)


def test_segment_seam_errors(models, port_heads):
    tmodel = models["full"][0]
    plan, _ = port_heads
    x = quantize_input(torch.as_tensor(IMAGES[:1]), 8)
    env = {tmodel.graph.input_edge: x}
    with pytest.raises(ValueError, match="node_range \\+ env_in"):
        int_forward(tmodel, plan, x, node_range=(0, 3))
    with pytest.raises(ValueError, match="node_range \\+ env_in"):
        int_forward(tmodel, plan, x, env_in=env, out_edges=("x",))
    for kw in ({"keep_env": True}, {"engine": "pallas"},
               {"engine": "packed"}):
        with pytest.raises(ValueError, match="segments run"):
            int_forward(tmodel, plan, None, env_in=env, node_range=(0, 1),
                        out_edges=(tmodel.graph.nodes[0].dst,), **kw)
    n = len(tmodel.graph.nodes)
    for s in (0, n + 1):
        with pytest.raises(ValueError, match=f"n_stages={s} for a {n}-node"):
            tpp.build_pipeline_spec(tmodel, s, 1, 1)


def test_pp_two_stages_bitwise(ranks, port_heads, jax_heads):
    _assert_heads(ranks["s2"], port_heads, jax_heads)


def test_pp_four_stages_bitwise(ranks, port_heads, jax_heads):
    _assert_heads(ranks["s4"], port_heads, jax_heads)
    # on the CPU the wrappers run their plain versions and count nothing
    assert ranks["launches"].tolist() == [0, 0, 0, 0]


def test_dp_pp_mesh_bitwise(ranks, port_heads, jax_heads):
    _assert_heads(ranks["dp_pp"], port_heads, jax_heads)


def test_pp_batch_guard(ranks):
    assert ranks["guard"] == ("pipeline batch must be "
                              "microbatch*n_microbatches = 4, got 3")


def test_pp_full_quant_detections_equal_single_rank(models, ranks,
                                                    port_heads):
    """build_pp_pipeline decodes the raw accumulators with the sigmoid in
    the decode (JAX's build_pp_pipeline): bit for bit the single-rank run
    of that program, and the serving pipeline's (deferred-sigmoid) keep
    sets, classes and scores, with boxes equal too."""
    tmodel = models["full"][0]
    plan, heads = port_heads
    det, n = non_max_suppression(
        decode_full_quant(tmodel, plan, requant_heads(tmodel, plan, heads)),
        q_nms_params(tmodel.head.anchor_scale))
    got_det, got_n = ranks["fq_dets"]
    np.testing.assert_array_equal(got_n, n.numpy())
    np.testing.assert_array_equal(got_det, det.numpy())
    det1, n1 = build_int_pipeline(tmodel, "cpu")[0](IMAGES)
    np.testing.assert_array_equal(got_n, n1.numpy())
    assert int(n1.sum()) > 0
    for b in range(len(IMAGES)):
        k = int(n1[b])
        np.testing.assert_array_equal(got_det[b, :k], det1[b, :k].numpy())


def test_pp_partial_quant_detections_equal_int_pipeline(models, ranks):
    tmodel = models["partial"][0]
    det, n = build_int_pipeline(tmodel, "cpu", dfl_w_float=DFL)[0](IMAGES)
    got_det, got_n = ranks["pq_dets"]
    assert int(n.sum()) > 0
    np.testing.assert_array_equal(got_n, n.numpy())
    np.testing.assert_array_equal(got_det, det.numpy())
