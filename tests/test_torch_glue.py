"""The graph glue's residual adds and concats (runtime/fused_ops.py
residual_add / concat, csrc/glue.cu) on the CPU: the plain versions against
a numpy int64 statement of requantize_np + add + clip + cast and of
requant + cat, the host side of the kernel's launch (its parts, offsets and
strides) through a numpy stand-in for the C entry, the launch path's
refusals, and the whole fused forward at 64 px against golden_forward, with
the full-quant decode's forms on its heads. No JAX.

The kernel itself runs only on a card: tests/test_torch_gpu.py holds it to
these plain versions bit for bit."""

import numpy as np
import pytest
import torch

from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.models.graph import (
    ConcatNode, ResidualAddNode, build_yolov8_graph,
)
from alpha_yolo_quant_torch.models.params import init_params
from alpha_yolo_quant_torch.postprocess.nms import xywh2xyxy
from alpha_yolo_quant_torch.quantize.calibrate import (
    collect_stats, reduce_stats,
)
from alpha_yolo_quant_torch.quantize.primitives import requantize_np
from alpha_yolo_quant_torch.quantize.transform import build_quantized_model
from alpha_yolo_quant_torch.runtime import _build, fused_ops
from alpha_yolo_quant_torch.runtime.golden import (
    decode_full_quant_np, golden_forward,
)
from alpha_yolo_quant_torch.runtime.interpreter import (
    decode_full_quant, decode_select_sparse, decode_serving, device_plan,
    int_forward, quantize_input, requant_heads,
)

QMAX = 127
NP = {torch.int8: np.int8, torch.int16: np.int16}
DTYPES = [torch.int8, torch.int16]


def _values(rng, shape, dtype):
    """int8: the whole range; int16: within +-3*qmax, the widest a wide
    edge holds. Either way the first values are +-qmax (and +-3*qmax)."""
    amax = 3 * QMAX if dtype == torch.int16 else QMAX
    x = rng.integers(-amax - (dtype == torch.int8), amax + 1, shape)
    flat = x.reshape(-1)
    edges = [QMAX, -QMAX] + ([3 * QMAX, -3 * QMAX]
                             if dtype == torch.int16 else [-128])
    n = min(len(edges), flat.size)
    flat[:n] = edges[:n]
    return x.astype(NP[dtype])


def _requant(rng, x):
    """A random (old, new) scale pair: requantize_np's int64 result and
    the (rescale, shift) it derived."""
    new = float(rng.uniform(0.01, 1.0))
    old = new * float(rng.uniform(0.3, 3.0))
    q, r, s = requantize_np(x, old, new, 8)
    return q, (int(r), int(s))


def _np_add(x, base, r_q, bound, out_dtype):
    out = r_q + base.astype(np.int64)
    if bound is not None:
        out = np.clip(out, -bound, bound)
    return out.astype(NP[out_dtype])


@pytest.mark.parametrize("bound", [None, 127], ids=["noclip", "clip"])
@pytest.mark.parametrize("out_dt", DTYPES, ids=["out8", "out16"])
@pytest.mark.parametrize("base_dt", DTYPES, ids=["base8", "base16"])
@pytest.mark.parametrize("src_dt", DTYPES, ids=["src8", "src16"])
def test_residual_add_plain_equals_numpy(src_dt, base_dt, out_dt, bound):
    """requantize_np + add + clip + numpy's wrapping cast; the int8 output
    of an unclipped sum of +-(qmax + 3*qmax) wraps as torch's .to() does."""
    rng = np.random.default_rng(hash((src_dt, base_dt, out_dt, bound))
                                % 2 ** 32)
    shape = (2, 5, 3, 24)
    x, base = _values(rng, shape, src_dt), _values(rng, shape, base_dt)
    q, (r, s) = _requant(rng, x)
    got = fused_ops.residual_add(torch.as_tensor(x), torch.as_tensor(base),
                                 r, s, QMAX, bound, out_dt)
    assert got.dtype == out_dt
    np.testing.assert_array_equal(got.numpy(),
                                  _np_add(x, base, q, bound, out_dt))


CONCATS = [(1, "1"), (2, "01"), (3, "001"), (4, "1111"), (5, "00000"),
           (6, "010110"), (7, "1000001"), (8, "01010101"), (8, "00000000")]


@pytest.mark.parametrize("out_dt", DTYPES, ids=["out8", "out16"])
@pytest.mark.parametrize("n,mask", CONCATS,
                         ids=[f"{n}src-{m}" for n, m in CONCATS])
def test_concat_plain_equals_numpy(n, mask, out_dt):
    """requant (where the mask says) + cast + cat over the channels, the
    sources of mixed dtypes and widths."""
    rng = np.random.default_rng(n * 1000 + int(mask, 2)
                                + (out_dt == torch.int16))
    srcs, reqs, want = [], [], []
    for i in range(n):
        dt = DTYPES[int(rng.integers(2))]
        x = _values(rng, (2, 3, 4, int(rng.choice([8, 16, 24, 32]))), dt)
        if mask[i] == "1":
            q, rq = _requant(rng, x)
        else:
            q, rq = x.astype(np.int64), None
        srcs.append(torch.as_tensor(x))
        reqs.append(rq)
        want.append(q.astype(NP[out_dt]))
    got = fused_ops.concat(srcs, reqs, QMAX, out_dt)
    assert got.dtype == out_dt
    np.testing.assert_array_equal(got.numpy(), np.concatenate(want, axis=3))


def test_plain_versions_count_no_launch():
    fused_ops.reset_counts()
    x = torch.zeros((1, 2, 2, 16), dtype=torch.int8)
    fused_ops.residual_add(x, x, 1, 1, QMAX, None, torch.int8)
    fused_ops.concat([x, x], [None, (1, 1)], QMAX, torch.int8)
    assert fused_ops.LAUNCHES["glue_add"] == fused_ops.LAUNCHES[
        "glue_concat"] == 0


def test_plain_path_takes_what_the_kernel_refuses():
    """On a CPU tensor the wrappers are the plain torch code, unchanged:
    a requant of int16 with r = 2^16 (koeff_bits 17) and a concat of 9
    sources, both refused by the launch path, still equal numpy."""
    rng = np.random.default_rng(11)
    x = _values(rng, (1, 2, 3, 16), torch.int16)
    base = _values(rng, (1, 2, 3, 16), torch.int8)
    r, s = 2 ** 16, 17
    q = (r * x.astype(np.int64)) >> (s - 1)
    q = np.clip((q >> 1) + (q & 1), -QMAX, QMAX)
    got = fused_ops.residual_add(torch.as_tensor(x), torch.as_tensor(base),
                                 r, s, QMAX, None, torch.int16)
    np.testing.assert_array_equal(got.numpy(),
                                  _np_add(x, base, q, None, torch.int16))
    srcs = [_values(rng, (1, 2, 3, 8), torch.int8) for _ in range(9)]
    got = fused_ops.concat([torch.as_tensor(t) for t in srcs], [None] * 9,
                           QMAX, torch.int8)
    np.testing.assert_array_equal(got.numpy(), np.concatenate(srcs, axis=3))


# ------------------------------------------------- the launch's host side

def _view(addr, dtype, n):
    return np.ctypeslib.as_array(
        (np.ctypeslib.as_ctypes_type(dtype) * n).from_address(addr))


def requant_combine_np(n, ptrs, rows, meta, out16, qmax, clip, bound,
                       stream):
    """csrc/glue.cu's ayq_requant_combine in numpy: the same parts, read
    and written through the same raw pointers, the requant in int64."""
    assert 1 <= n <= fused_ops.MAX_SOURCES and stream == 0
    width = {0: np.int8, 1: np.int16}
    for i in range(n):
        cols, stride, src16, base16, req, r, s = meta[7 * i:7 * i + 7]
        nrow = rows[i]
        assert cols >= 1 and stride >= cols and nrow >= 0
        if nrow == 0:
            continue
        v = _view(ptrs[3 * i], width[src16], nrow * cols).astype(np.int64)
        if req:
            q = (r * v) >> (s - 1)
            v = np.clip((q >> 1) + (q & 1), -qmax, qmax)
        if ptrs[3 * i + 1] is not None:
            v = v + _view(ptrs[3 * i + 1], width[base16], nrow * cols)
            if clip:
                v = np.clip(v, -bound, bound)
        out = _view(ptrs[3 * i + 2], width[out16], (nrow - 1) * stride + cols)
        at = (np.arange(nrow)[:, None] * stride + np.arange(cols)).ravel()
        out[at] = v.astype(width[out16])
    return 0


@pytest.fixture
def stand_in(monkeypatch):
    """The kernel's launch path on CPU tensors, the C entry replaced by
    requant_combine_np (the wrappers send CPU tensors to the plain
    versions, so the tests call the launch functions themselves)."""
    monkeypatch.setattr(_build, "kernel",
                        lambda src, fn: requant_combine_np)
    monkeypatch.setattr(fused_ops, "_stream", lambda t: 0)
    fused_ops.reset_counts()


def test_wrappers_refuse_what_the_kernel_cannot_take(stand_in):
    """The launch path refuses more than 8 sources, and a requant whose
    product |r * x| may reach 2^31 (the kernel's 32-bit requant would no
    longer be exact); r = 2^16 - 1 still fits int16."""
    x8 = torch.zeros((1, 2, 2, 16), dtype=torch.int8)
    x16 = x8.to(torch.int16)
    i8 = torch.int8
    with pytest.raises(ValueError, match="1 to 8"):
        fused_ops._launch_concat([x8] * 9, [None] * 9, QMAX, i8)
    with pytest.raises(ValueError, match="requants"):
        fused_ops._launch_concat([x8] * 2, [None], QMAX, i8)
    with pytest.raises(ValueError, match="r=65536"):
        fused_ops._launch_add(x16, x8, 2 ** 16, 8, QMAX, None, i8)
    with pytest.raises(ValueError, match="s=0"):
        fused_ops._launch_concat([x8], [(3, 0)], QMAX, i8)
    assert fused_ops.LAUNCHES["glue_add"] == fused_ops.LAUNCHES[
        "glue_concat"] == 0
    fused_ops._launch_add(x16, x8, 2 ** 16 - 1, 8, QMAX, None, i8)
    fused_ops._launch_add(x8, x8, 2 ** 24 - 1, 32, QMAX, None, i8)
    assert fused_ops.LAUNCHES["glue_add"] == 2


def test_empty_tensors_launch_nothing(stand_in):
    """No element, no launch and no count; an empty concat source is left
    out of the launch, the others still written at their offsets."""
    e = torch.zeros((0, 2, 2, 16), dtype=torch.int8)
    assert fused_ops._launch_add(e, e, 3, 2, QMAX, None,
                                 torch.int8).shape == e.shape
    assert fused_ops._launch_concat([e, e], [None, (3, 2)], QMAX,
                                    torch.int16).shape == (0, 2, 2, 32)
    assert fused_ops.LAUNCHES["glue_add"] == fused_ops.LAUNCHES[
        "glue_concat"] == 0
    rng = np.random.default_rng(12)
    x = torch.as_tensor(_values(rng, (1, 2, 2, 16), torch.int8))
    srcs, reqs = [x, x[..., :0], x], [None, None, (3, 2)]
    got = fused_ops._launch_concat(srcs, reqs, QMAX, torch.int8)
    assert torch.equal(got, fused_ops.concat_plain(srcs, reqs, QMAX,
                                                   torch.int8))
    assert fused_ops.LAUNCHES["glue_concat"] == 1


@pytest.mark.parametrize("bound", [None, 127], ids=["noclip", "clip"])
@pytest.mark.parametrize("shape", [(2, 4, 4, 32), (1, 3, 5, 7), (1, 1, 1, 3)],
                         ids=["c32", "c7", "c3-one-pixel"])
def test_add_launch_parts_equal_plain(stand_in, shape, bound):
    """An add as one part: B*H*W rows of C channels, base and output laid
    out as the source."""
    rng = np.random.default_rng(sum(shape))
    x = torch.as_tensor(_values(rng, shape, torch.int16))
    base = torch.as_tensor(_values(rng, shape, torch.int8))
    for out_dt in DTYPES:
        got = fused_ops._launch_add(x, base, 200, 8, QMAX, bound, out_dt)
        want = fused_ops.residual_add_plain(x, base, 200, 8, QMAX, bound,
                                            out_dt)
        assert got.dtype == out_dt and torch.equal(got, want)
    assert fused_ops.LAUNCHES["glue_add"] == 2


@pytest.mark.parametrize("widths", [(16, 32, 16, 48), (16, 8, 24),
                                    (3, 5, 7, 9, 11, 13, 15, 17)],
                         ids=["x16", "ragged", "8src"])
def test_concat_launch_parts_equal_plain(stand_in, widths):
    """Each source at its channel offset, the output row stride the sum of
    the widths, a requant on every other source."""
    rng = np.random.default_rng(len(widths))
    srcs = [torch.as_tensor(_values(rng, (2, 3, 2, c), DTYPES[i % 2]))
            for i, c in enumerate(widths)]
    reqs = [(150 + i, 7) if i % 2 else None for i in range(len(widths))]
    for out_dt in DTYPES:
        got = fused_ops._launch_concat(srcs, reqs, QMAX, out_dt)
        want = fused_ops.concat_plain(srcs, reqs, QMAX, out_dt)
        assert got.dtype == out_dt and torch.equal(got, want)
    assert fused_ops.LAUNCHES["glue_concat"] == 2


def test_launch_refuses_strided_and_mixed_sources(stand_in):
    x = torch.zeros((1, 2, 2, 32), dtype=torch.int8)
    with pytest.raises(ValueError, match="contiguous"):
        fused_ops._launch_concat([x[..., :16], x], [None, None], QMAX,
                                 torch.int8)
    with pytest.raises(ValueError, match="contiguous"):
        fused_ops._launch_concat([x, x[:, :1]], [None, None], QMAX,
                                 torch.int8)
    with pytest.raises(TypeError, match="int8 or int16"):
        fused_ops._launch_add(x.to(torch.int32), x, 1, 1, QMAX, None,
                              torch.int8)
    with pytest.raises(ValueError, match="differ"):
        fused_ops._launch_add(x, x[..., :16].contiguous(), 1, 1, QMAX, None,
                              torch.int8)
    assert fused_ops.LAUNCHES["glue_add"] == fused_ops.LAUNCHES[
        "glue_concat"] == 0


# --------------------------------------------------------- whole forward

@pytest.fixture(scope="module")
def forwards():
    """model name -> (model, plan, fused int_forward with keep_env,
    golden_forward's env) of two images at 64 px, the model calibrated on
    random weights; each built once a module."""
    cache = {}

    def get(model):
        if model not in cache:
            cfg = QuantConfig(model=model, k=8, full_quant=True,
                              image_size=64)
            graph = build_yolov8_graph(cfg)
            params = init_params(graph, seed=0)
            calib = np.random.default_rng(0).uniform(
                0, 1, (2, 3, 64, 64)).astype(np.float32)
            qm = build_quantized_model(
                graph, params,
                reduce_stats(collect_stats(graph, params, [calib], "cpu")),
                cfg)
            x = np.random.default_rng(1).uniform(
                0, 1, (2, 3, 64, 64)).astype(np.float32)
            plan = device_plan(qm, "cpu")
            outs = int_forward(qm, plan, quantize_input(torch.as_tensor(x), 8),
                               keep_env=True)
            cache[model] = qm, plan, outs, golden_forward(qm, x)
        return cache[model]

    return get


@pytest.mark.parametrize("model,n_add,n_cat", [("yolov8n", 6, 13),
                                               ("yolov8m-p6", 14, 18)])
def test_fused_forward_equals_golden(forwards, model, n_add, n_cat):
    """The fused int_forward at 64 px with keep_env: every edge and every
    residual/concat requant intermediate equals golden_forward's."""
    qm, _, outs, want = forwards(model)
    graph = qm.graph
    assert sum(isinstance(n, ResidualAddNode) for n in graph.nodes) == n_add
    assert sum(isinstance(n, ConcatNode) for n in graph.nodes) == n_cat
    env = outs["__env__"]
    glue = {k for k in want if k.endswith((":rescale", ":requant"))}
    assert len(glue) >= n_add and glue <= set(env)
    assert {n.dst for n in graph.nodes
            if isinstance(n, (ResidualAddNode, ConcatNode))} <= set(env)
    for key in set(want) & set(env):
        np.testing.assert_array_equal(env[key].numpy().astype(np.int64),
                                      want[key], err_msg=key)
    for role in graph.outputs:
        np.testing.assert_array_equal(outs[role].numpy().astype(np.int64),
                                      want[role], err_msg=role)


@pytest.mark.parametrize("model,n", [("yolov8n", 84), ("yolov8m-p6", 85)],
                         ids=["yolov8n", "yolov8m-p6"])
def test_decode_forms_agree(forwards, model, n):
    """On that forward's requant_heads: decode_full_quant's plane equals
    golden's decode_full_quant_np; without the sigmoid its class rows are
    the sigmoid LUT's inputs; decode_serving's boxes are the plane's and
    its (conf, cid) the class rows' max and lowest argmax; and
    decode_select_sparse keeps the top 32 of them in descending conf,
    ties to the lowest anchor, with the serving boxes as xyxy."""
    qm, plan, outs, want = forwards(model)
    heads = requant_heads(qm, plan, {r: outs[r] for r in qm.graph.outputs})
    plane = decode_full_quant(qm, plan, heads)
    assert tuple(plane.shape) == (2, 84, n)
    np.testing.assert_array_equal(plane.numpy().astype(np.float64),
                                  decode_full_quant_np(qm, want))
    raw = decode_full_quant(qm, plan, heads, sigmoid_cls=False)
    cls = raw[:, 4:].to(torch.int64)
    assert torch.equal(raw[:, :4], plane[:, :4])
    assert torch.equal(plan["head"]["cls_sig_lut"].apply(cls).to(
        torch.float32), plane[:, 4:])
    dbox, conf, cid = decode_serving(qm, plan, heads)
    assert torch.equal(dbox, plane[:, :4])
    best = cls.amax(1)
    assert torch.equal(conf, best.to(torch.float32))
    assert torch.equal(cid, (cls == best[:, None]).to(torch.int64).argmax(
        1).to(torch.float32))
    m = 32
    thres = float(conf[0].sort(descending=True).values[m // 2]) - 0.5
    boxes, conf_s, cid_s, valid = decode_select_sparse(
        qm, plan, heads, pre_topk=m, conf_thres=thres)
    order = torch.sort(conf, dim=1, descending=True,
                       stable=True).indices[:, :m]
    assert torch.equal(conf_s, torch.gather(conf, 1, order))
    assert torch.equal(cid_s, torch.gather(cid, 1, order))
    assert torch.equal(boxes, xywh2xyxy(torch.gather(
        dbox, 2, order[:, None].expand(-1, 4, -1)).transpose(1, 2)))
    assert torch.equal(valid, conf_s > thres) and valid.any()
