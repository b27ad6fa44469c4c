"""The PyTorch port's Hopper kernels on a CUDA card: each kernel against its
plain version, and the 64-px pipeline on the card, on every engine,
against the CPU run and the numpy int64 oracle. Bit-exact.

These tests need a card and nvcc and skip without them. They import
neither JAX nor the JAX package, so they also run where JAX is not
installed, without the repo's conftest.py (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

from typing import List

import numpy as np
import pytest
import torch

from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.models.graph import build_yolov8_graph
from alpha_yolo_quant_torch.models.params import init_params
from alpha_yolo_quant_torch.ops.lut import DeviceLut
from alpha_yolo_quant_torch.ops.nn import conv2d_int_parts
from alpha_yolo_quant_torch.quantize.calibrate import (
    collect_stats, reduce_stats,
)
from alpha_yolo_quant_torch.quantize.luts import sigmoid_lut
from alpha_yolo_quant_torch.quantize.transform import build_quantized_model
from alpha_yolo_quant_torch.runtime import fused_ops
from alpha_yolo_quant_torch.runtime import packed_conv as pc
from alpha_yolo_quant_torch.runtime.golden import golden_forward
from alpha_yolo_quant_torch.runtime.interpreter import (
    build_int_pipeline, device_plan, int_forward, quantize_input,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernels have no CPU mode)")
    return torch.device("cuda")


# (cin, cout, kernel, stride, hw, wide input, silu): ragged rows (M not a
# multiple of the 128-row tile) and columns (Cout 20, 72 inside a wider
# tile; 272 over two column blocks), the Cin = 3 and Cin % 16 != 0
# gathered loads, int16 inputs (two byte passes), every yolov8n column
# tile (16, 32, 64, 80, 128, 256), depth up to 9*256
CASES = [(3, 16, 3, 2, 33, False, True), (16, 16, 3, 1, 20, False, True),
         (32, 64, 3, 2, 41, False, True), (48, 32, 1, 1, 13, False, True),
         (64, 64, 1, 1, 10, False, False), (80, 80, 1, 1, 10, False, False),
         (32, 32, 3, 1, 9, True, True), (128, 64, 1, 1, 7, True, True),
         (6, 20, 3, 1, 5, True, False), (256, 72, 3, 1, 6, False, True),
         (64, 80, 1, 1, 13, False, True), (80, 80, 3, 1, 12, False, False),
         (64, 128, 3, 2, 15, False, True), (128, 256, 3, 2, 11, False, True),
         (256, 256, 3, 1, 9, True, False), (512, 256, 1, 1, 7, False, True),
         (32, 32, 1, 1, 15, False, True), (64, 272, 1, 1, 6, False, False),
         (20, 24, 1, 1, 9, True, True)]


@pytest.mark.parametrize("case", CASES, ids=[
    f"{c[0]}-{c[1]}-k{c[2]}s{c[3]}-{c[4]}px{'-wide' if c[5] else ''}"
    f"{'' if c[6] else '-plain'}" for c in CASES])
def test_conv_kernel_equals_plain(cuda, case):
    cin, cout, k, stride, hw, wide, silu = case
    rng = np.random.default_rng(hash(case) % 2 ** 32)
    amax = 381 if wide else 127
    x = torch.as_tensor(rng.integers(-amax, amax + 1, (3, hw, hw, cin)),
                        dtype=torch.int16 if wide else torch.int8,
                        device=cuda)
    w = rng.integers(-127, 128, (cout, cin, k, k))
    b = rng.integers(-2 ** 15, 2 ** 15, cout)
    r1, r2 = rng.integers(1, 256, cout), rng.integers(1, 256, cout)
    s1, s2 = rng.integers(1, 24, cout), rng.integers(8, 32, cout)
    c = fused_ops.conv_entry(w, b, stride, k // 2, silu, cuda, r1=r1, s1=s1,
                             r2=r2, s2=s2)
    sig = DeviceLut(sigmoid_lut(6.0, 8), cuda)
    wrapper = fused_ops.conv1x1 if k == 1 else fused_ops.conv3x3
    before = fused_ops.LAUNCHES[wrapper.__name__]
    got = wrapper(x, c, sig, 127)
    want = fused_ops.conv_plain(x, c, sig, 127)
    torch.cuda.synchronize()
    assert fused_ops.LAUNCHES[wrapper.__name__] == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("amax,sign", [(127, 1), (127, -1), (381, 1),
                                       (381, -1)],
                         ids=["int8+", "int8-", "wide+", "wide-"])
def test_conv_kernel_accumulator_extremes(cuda, amax, sign):
    """Every weight +127 against inputs of +-127 (int8) or +-381 (wide
    int16) at depth 9*256, bias +-2^15: the interior sums reach
    +-(amax*127*2304 + 2^15), the largest a yolov8n K=8 conv can hold."""
    x = torch.full((2, 6, 6, 256), sign * amax, device=cuda,
                   dtype=torch.int16 if amax > 127 else torch.int8)
    c = fused_ops.conv_entry(np.full((32, 256, 3, 3), 127),
                             np.full(32, sign * 2 ** 15), 1, 1, False, cuda)
    got = fused_ops.conv3x3(x, c)
    want = fused_ops.conv_plain(x, c, None, 127)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int(got[:, 1:-1, 1:-1].min() * sign) == amax * 127 * 2304 + 2 ** 15


def test_sigma_probe_returns_the_table(cuda):
    sig = DeviceLut(sigmoid_lut(6.0, 8), cuda)
    assert torch.equal(fused_ops.sigma_probe(sig).cpu(),
                       torch.as_tensor(sig.lut.values))
    assert fused_ops.sigma_corrections(sig) == ()


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "plain"])
@pytest.mark.parametrize("axis", [1, 3], ids=["nchw", "nhwc"])
def test_postconv_kernel_equals_plain(cuda, silu, axis):
    """K3/K4 on the real nibble-split partials of a wide-input conv,
    ragged element count, channel axis 1 (the JAX layout) or 3."""
    rng = np.random.default_rng(axis + 2 * silu)
    x = torch.as_tensor(rng.integers(-381, 382, (3, 13, 11, 20)),
                        dtype=torch.int16, device=cuda)
    w = rng.integers(-127, 128, (24, 20, 3, 3))
    b = rng.integers(-2 ** 15, 2 ** 15, 24)
    r1, r2 = rng.integers(64, 256, 24), rng.integers(64, 256, 24)
    s1, s2 = rng.integers(18, 24, 24), rng.integers(26, 32, 24)
    c = fused_ops.conv_entry(w, b, 1, 1, silu, cuda, r1=r1, s1=s1, r2=r2,
                             s2=s2)
    hi, lo = conv2d_int_parts(x, c)
    if axis == 1:
        hi, lo = (t.permute(0, 3, 1, 2).contiguous() for t in (hi, lo))
    sig = DeviceLut(sigmoid_lut(6.0, 8), cuda)
    name = "postconv_silu" if silu else "postconv_plain"
    before = fused_ops.LAUNCHES[name]
    if silu:
        consts = [c[f] for f in ("b", "r1", "s1", "r2", "s2")]
        got = fused_ops.postconv_silu(hi, lo, *consts, sig, axis=axis)
        want = fused_ops.postconv_silu_plain(hi, lo, *consts, sig,
                                             axis=axis)
    else:
        got = fused_ops.postconv_plain(hi, lo, c["b"], axis=axis)
        want = fused_ops.postconv_plain_plain(hi, lo, c["b"], axis=axis)
    torch.cuda.synchronize()
    assert fused_ops.LAUNCHES[name] == before + 1
    assert got.dtype == want.dtype and torch.equal(got, want)


def _packed_lanes(rng, plan, silu):
    cout = plan.cout
    bias = pc.pack_lane_const(rng.integers(-900, 900, cout), plan)
    if not silu:
        z = pc.pack_lane_const(np.zeros(cout), plan)
        o = pc.pack_lane_const(np.ones(cout), plan, fill=1)
        return bias, z, o, z, o
    s1 = rng.integers(18, 22, cout)
    return (bias, pc.pack_lane_const(rng.integers(64, 256, cout), plan),
            pc.pack_lane_const(s1, plan, fill=1),
            pc.pack_lane_const(rng.integers(64, 256, cout), plan),
            pc.pack_lane_const(s1 + 7, plan, fill=1))


# (kind, cin, cout, hw, silu): stride 1 (one slab, and the wide two-slab
# 18-tap form), stride 2 over even/odd row blocks, the down2 1x1 over
# three wide even/odd part pairs; SiLU (int8) and raw (int32) epilogues
PACKED_CASES = [("s1", 16, 16, 40, True), ("s1", 64, 64, 24, False),
                ("s1_wide", 32, 32, 20, True), ("s2", 16, 32, 40, True),
                ("s2", 64, 128, 16, False), ("down2", 48, 32, 24, True)]


@pytest.mark.parametrize("case", PACKED_CASES,
                         ids=[f"{c[0]}-{c[1]}-{c[2]}-{c[3]}px-"
                              f"{'silu' if c[4] else 'raw'}"
                              for c in PACKED_CASES])
def test_packed_conv_kernel_equals_plain(cuda, case):
    kind, cin, cout, hw, silu = case
    rng = np.random.default_rng(cin * 7 + hw)
    sig = DeviceLut(sigmoid_lut(6.0, 8), cuda)
    amax = 381 if kind == "down2" else 254 if kind == "s1_wide" else 127
    x = rng.integers(-amax, amax + 1, (3, hw, hw, cin))
    parts, rem = [], x
    while len(parts) < -(-amax // 127):
        parts.append(np.clip(rem, -127, 127))
        rem = rem - parts[-1]
    parts = [torch.as_tensor(p, device=cuda) for p in parts]
    if kind == "down2":
        plan = pc.make_down2_plan(cin, cout, hw)
        mats = pc.down2_weight_mats(
            rng.integers(-127, 128, (cout, cin, 1, 1)), plan)
        slabs = [s for p in parts for s in pc.pack_tensor_down2(p, plan)]
        run = pc.packed_conv_down2
        args = (slabs, mats, *_packed_lanes(rng, plan, silu), plan, hw)
    else:
        plan = pc.make_plan(cin, cout, 2 if kind == "s2" else 1, hw)
        mats = pc.packed_weight_mats(
            rng.integers(-127, 128, (cout, cin, 3, 3)), plan)
        lanes = _packed_lanes(rng, plan, silu)
        if kind == "s2":
            run = pc.packed_conv_s2
            args = (*pc.pack_tensor_s2(parts[0], plan), mats, *lanes, plan,
                    hw)
        else:
            run = pc.packed_conv_slab
            args = (pc.pack_tensor(parts[0], plan), mats, *lanes, plan, hw)
    kw = dict(sig=sig, silu=silu)
    if kind == "s1_wide":
        kw["x_slab2"] = pc.pack_tensor(parts[1], plan)
    before = fused_ops.LAUNCHES["packed_conv"]
    got = run(*args, **kw)
    torch.cuda.synchronize()
    assert fused_ops.LAUNCHES["packed_conv"] == before + 1
    cpu = [[t.cpu() for t in a] if isinstance(a, list)
           else a.cpu() if torch.is_tensor(a) else a for a in args]
    kw_cpu = {k: v.cpu() if torch.is_tensor(v) else v for k, v in kw.items()}
    kw_cpu["sig"] = DeviceLut(sigmoid_lut(6.0, 8), "cpu")
    want = run(*cpu, **kw_cpu)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.cpu(), want)


def block_sparse(rng, keep: float, n: int = 1) -> List[np.ndarray]:
    """n random int8 (128, 128) tap matrices whose k32 x n16 blocks are
    each nonzero with probability ``keep``, with zeros inside kept blocks
    too."""
    out = []
    for _ in range(n):
        w = rng.integers(-127, 128, (128, 128)) * (rng.random((128, 128))
                                                   < 0.7)
        blocks = rng.random((4, 1, 8, 1)) < keep
        out.append((w.reshape(4, 32, 8, 16) * blocks).reshape(128, 128)
                   .astype(np.int8))
    return out


# Direct packed_call cases at the kernel's edges: (kind, silu). dense: no
# block skipped (three tap groups); zero_tap: one tap matrix all zeros;
# dead: n16 pieces with zero columns in every matrix and zero bias, and one
# with a bias; ragged: m = 35, under one 128-row tile (the others have
# m = 288, not a multiple of it either); limits: 32 taps over 8 slabs;
# extreme+/-: every input +127 and every weight +-127 over 32 taps, the
# accumulator's largest magnitude
PACKED_EDGES = [("dense", True), ("zero_tap", False), ("dead", True),
                ("ragged", True), ("limits", False), ("extreme+", False),
                ("extreme-", False)]


def packed_edge_case(kind: str, silu: bool, device, seed: int = 0):
    """(x_slabs, taps, entry, gp2, h_out, sig) of one PACKED_EDGES case."""
    rng = np.random.default_rng(seed + sum(map(ord, kind)))
    g, h_out, batch = {"ragged": (5, 5, 3)}.get(kind, (16, 16, 2))
    gp2 = g + 2
    r_ext = pc.rows_ext(h_out + 2, gp2)
    n_slabs = 8 if kind in ("limits", "extreme+", "extreme-") else 1
    s1_bases = [pc.FRONT_PAD + dy * gp2 + gg - 1 for dy in range(3)
                for gg in range(3)]
    if n_slabs == 8:     # 32 taps: every slab at four of the s1 bases
        taps = [(t % 8, t, s1_bases[t % 9]) for t in range(32)]
    elif kind == "zero_tap":
        taps = [(0, t, s1_bases[3 * t + 1]) for t in range(3)]
    else:
        taps = [(0, t, base) for t, base in enumerate(s1_bases)]
    if kind == "dense":
        wl = [(rng.integers(1, 128, (128, 128)) * rng.choice([-1, 1], (
            128, 128))).astype(np.int8) for _ in taps]
    elif kind.startswith("extreme"):
        sign = 1 if kind == "extreme+" else -1
        wl = [np.full((128, 128), 127 * sign, np.int8) for _ in taps]
    else:
        wl = block_sparse(rng, 0.4, len(taps))
        if kind == "zero_tap":
            wl[1][:] = 0
    bias = rng.integers(-900, 900, 128)
    if kind == "dead":   # piece 6: zero columns but a bias, so live
        for w in wl:
            w.reshape(128, 8, 16)[:, [1, 4, 5, 6]] = 0
        bias.reshape(8, 16)[[1, 4, 5]] = 0
    if kind.startswith("extreme"):
        xs = [torch.full((batch, r_ext, 128), 127, dtype=torch.int8)
              for _ in range(n_slabs)]
        bias[:] = 2 ** 15 * (1 if kind == "extreme+" else -1)
    else:
        xs = [torch.as_tensor(rng.integers(-127, 128, (batch, r_ext, 128)),
                              dtype=torch.int8) for _ in range(n_slabs)]
    s1 = rng.integers(18, 22, 128)
    e = pc.packed_entry(wl, bias, rng.integers(64, 256, 128), s1,
                        rng.integers(64, 256, 128), s1 + 7, silu, device)
    return ([x.to(device) for x in xs], taps, e, gp2, h_out,
            DeviceLut(sigmoid_lut(6.0, 8), device))


@pytest.mark.parametrize("kind,silu", PACKED_EDGES,
                         ids=[k for k, _ in PACKED_EDGES])
def test_packed_call_edges_equal_plain(cuda, kind, silu):
    x_slabs, taps, e, gp2, h_out, sig = packed_edge_case(kind, silu, cuda)
    before = fused_ops.LAUNCHES["packed_conv"]
    got = pc.packed_call(x_slabs, taps, e, gp2, h_out, sig)
    torch.cuda.synchronize()
    assert fused_ops.LAUNCHES["packed_conv"] == before + 1
    cx, ctaps, ce, _, _, csig = packed_edge_case(kind, silu, "cpu")
    want = pc.packed_call(cx, ctaps, ce, gp2, h_out, csig)
    assert got.dtype == want.dtype and torch.equal(got.cpu(), want)
    if kind.startswith("extreme"):
        sign = 1 if kind == "extreme+" else -1
        top = 32 * 128 * 127 * 127 + 2 ** 15
        assert int((got * sign).max()) == top and int(got.abs().max()) == top


def _card_model(full_quant=True, model="yolov8n"):
    cfg = QuantConfig(model=model, k=8, full_quant=full_quant,
                      image_size=64)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=0)
    calib = np.random.default_rng(0).uniform(0, 1, (2, 3, 64, 64)).astype(
        np.float32)
    return build_quantized_model(
        graph, params,
        reduce_stats(collect_stats(graph, params, [calib], "cpu")), cfg)


def test_pipeline_on_card_equals_cpu_and_golden(cuda):
    model = _card_model()
    graph = model.graph
    x = np.random.default_rng(1).uniform(0, 1, (4, 3, 64, 64)).astype(
        np.float32)
    fused_ops.reset_counts()
    det, n = build_int_pipeline(model, cuda)[0](torch.as_tensor(x,
                                                               device=cuda))
    assert fused_ops.LAUNCHES["conv1x1"] + fused_ops.LAUNCHES["conv3x3"] \
        == len(graph.convs())
    det_c, n_c = build_int_pipeline(model, "cpu")[0](x)
    assert torch.equal(det.cpu(), det_c) and torch.equal(n.cpu(), n_c)
    plan = device_plan(model, cuda)
    outs = int_forward(model, plan, quantize_input(
        torch.as_tensor(x[:1], device=cuda), 8))
    env = golden_forward(model, x[:1])
    for role in graph.outputs:
        np.testing.assert_array_equal(
            outs[role].cpu().numpy().astype(np.int64), env[role])


@pytest.mark.parametrize("engine", ["pallas", "packed"])
def test_engine_on_card_equals_cpu(cuda, engine):
    """The pallas and packed engines on the card launch their kernels and
    give the CPU run's detections."""
    model = _card_model()
    x = np.random.default_rng(2).uniform(0, 1, (3, 3, 64, 64)).astype(
        np.float32)
    fused_ops.reset_counts()
    det, n = build_int_pipeline(model, cuda, engine=engine)[0](
        torch.as_tensor(x, device=cuda))
    torch.cuda.synchronize()
    kernels = (("postconv_silu", "postconv_plain") if engine == "pallas"
               else ("packed_conv",))
    assert all(fused_ops.LAUNCHES[k] > 0 for k in kernels)
    det_c, n_c = build_int_pipeline(model, "cpu")[0](x)
    assert torch.equal(det.cpu(), det_c) and torch.equal(n.cpu(), n_c)


DFL = np.arange(16, dtype=np.float32)     # init_params' DFL weight


def _assert_dets_close(got, want):
    """The tolerance of the CPU test
    test_partial_quant_pipeline_matches_jax_within_f32_rounding: counts and
    classes exact, boxes atol 1e-3, scores rtol 1e-5."""
    det, n = (t.cpu().numpy() for t in got)
    det_c, n_c = (t.numpy() for t in want)
    np.testing.assert_array_equal(n, n_c)
    np.testing.assert_allclose(det[..., :4], det_c[..., :4], atol=1e-3)
    np.testing.assert_allclose(det[..., 4], det_c[..., 4], rtol=1e-5)
    np.testing.assert_array_equal(det[..., 5], det_c[..., 5])


def test_partial_quant_on_card_matches_cpu(cuda):
    """Partial quant: the six head edges come from the integer graph and
    equal the CPU's bit for bit; the float head (softmax, DFL, sigmoid) on
    the card matches the CPU pipeline within f32 rounding."""
    model = _card_model(full_quant=False)
    x = np.random.default_rng(3).uniform(0, 1, (3, 3, 64, 64)).astype(
        np.float32)
    outs = int_forward(model, device_plan(model, cuda),
                       quantize_input(torch.as_tensor(x, device=cuda), 8))
    outs_c = int_forward(model, device_plan(model, "cpu"),
                         quantize_input(torch.as_tensor(x), 8))
    for role in model.graph.outputs:
        assert torch.equal(outs[role].cpu(), outs_c[role]), role
    fused_ops.reset_counts()
    got = build_int_pipeline(model, cuda, dfl_w_float=DFL)[0](
        torch.as_tensor(x, device=cuda))
    torch.cuda.synchronize()
    assert fused_ops.LAUNCHES["conv1x1"] + fused_ops.LAUNCHES["conv3x3"] \
        == len(model.graph.convs())
    want = build_int_pipeline(model, "cpu", dfl_w_float=DFL)[0](x)
    assert int(want[1].sum()) > 0
    _assert_dets_close(got, want)


@pytest.mark.parametrize("full", [True, False], ids=["full", "partial"])
def test_yolov8m_on_card_equals_cpu_and_golden(cuda, full):
    """yolov8m: its Couts 384 and 576 take the conv kernels' multi-column
    block path. Every engine's head edges equal golden_forward; the
    detections equal the CPU pipeline (partial quant: within f32
    rounding)."""
    model = _card_model(full_quant=full, model="yolov8m")
    assert max(c.cout for c in model.graph.convs()) == 576
    x = np.random.default_rng(4).uniform(0, 1, (2, 3, 64, 64)).astype(
        np.float32)
    want = golden_forward(model, x)
    plan = device_plan(model, cuda)
    x_q = quantize_input(torch.as_tensor(x, device=cuda), 8)
    for engine in ("fused", "pallas", "packed"):
        outs = int_forward(model, plan, x_q, engine=engine)
        for role in model.graph.outputs:
            np.testing.assert_array_equal(
                outs[role].cpu().numpy().astype(np.int64), want[role],
                err_msg=f"{engine} {role}")
    got = build_int_pipeline(model, cuda, dfl_w_float=DFL)[0](
        torch.as_tensor(x, device=cuda))
    want_det = build_int_pipeline(model, "cpu", dfl_w_float=DFL)[0](x)
    if full:
        assert torch.equal(got[0].cpu(), want_det[0])
        assert torch.equal(got[1].cpu(), want_det[1])
    else:
        _assert_dets_close(got, want_det)


def test_uint8_ingest_on_card_is_ieee_division(cuda):
    """u/255 on the card equals the correctly rounded float32 quotient for
    every pixel value (a Python-float divisor would multiply by the
    reciprocal), and per_image_amax quantizes as on the CPU."""
    u = torch.arange(256, dtype=torch.uint8).reshape(1, 1, 16, 16)
    want = (np.arange(256, dtype=np.float32) / np.float32(255.0))
    for amax in (False, True):
        q = quantize_input(u.to(cuda), 8, per_image_amax=amax)
        assert torch.equal(q.cpu(), quantize_input(u, 8,
                                                   per_image_amax=amax))
    x = u.to(cuda).to(torch.float32) / torch.full((), 255.0, device=cuda)
    np.testing.assert_array_equal(x.cpu().numpy().reshape(-1), want)
    x = np.random.default_rng(5).uniform(0, 1, (3, 3, 16, 16)).astype(
        np.float32) * np.float32([0.3, 0.7, 1.0]).reshape(3, 1, 1, 1)
    assert torch.equal(
        quantize_input(torch.as_tensor(x, device=cuda), 8,
                       per_image_amax=True).cpu(),
        quantize_input(torch.as_tensor(x), 8, per_image_amax=True))
