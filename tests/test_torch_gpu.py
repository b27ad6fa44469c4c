"""The PyTorch port's Hopper kernels on a CUDA card: each kernel against its
plain version, and the 64-px pipeline on the card, on every engine,
against the CPU run and the numpy int64 oracle. Bit-exact.

These tests need a card and nvcc and skip without them. They import
neither JAX nor the JAX package, so they also run where JAX is not
installed, without the repo's conftest.py (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import functools
import threading
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
from alpha_yolo_quant_torch.runtime import fused_ops, ingest
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
    _assert_conv_equals_plain(x, c, sig)


def _assert_conv_equals_plain(x, c, sig):
    """One launch of the conv's wrapper, counted under the wrapper and
    under the loader its input takes, bit-equal to conv_plain."""
    wrapper = fused_ops.conv1x1 if c["kernel"] == 1 else fused_ops.conv3x3
    loader = fused_ops.conv_loader(x, c["cin"])
    before = dict(fused_ops.LAUNCHES)
    got = wrapper(x, c, sig, 127)
    want = fused_ops.conv_plain(x, c, sig, 127)
    torch.cuda.synchronize()
    for key in (wrapper.__name__, loader):
        assert fused_ops.LAUNCHES[key] == before[key] + 1, key
    others = {"conv_vector", "conv_wide", "conv_gather"} - {loader}
    assert all(fused_ops.LAUNCHES[k] == before[k] for k in others)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def _random_conv(rng, cin, cout, k, stride, shape, wide, silu):
    amax = 381 if wide else 127
    x = torch.as_tensor(rng.integers(-amax, amax + 1, shape + (cin,)),
                        dtype=torch.int16 if wide else torch.int8,
                        device="cuda")
    w = rng.integers(-127, 128, (cout, cin, k, k))
    b = rng.integers(-2 ** 15, 2 ** 15, cout)
    r1, r2 = rng.integers(1, 256, cout), rng.integers(1, 256, cout)
    s1, s2 = rng.integers(1, 24, cout), rng.integers(8, 32, cout)
    c = fused_ops.conv_entry(w, b, stride, k // 2, silu, "cuda", r1=r1,
                             s1=s1, r2=r2, s2=s2)
    return x, c


# (cin, cout, kernel, stride, (B, H, W), wide input, silu) for the
# persistent pipeline's tiles: the widths tile_n gives yolov8m (48, 96,
# 144 = 288 over two column tiles, 192; 384 and 576 over two and three),
# a ragged 272 = 2 x 144; M of one tile or less (25 rows); several tiles
# a block (B*H*W / 64 at least three times the card's 132 SMs: 25,600 to
# 32,768 rows), at BN <= 128 and wider (two register splits); depth of
# many ring laps (9*192, 9*576: the main loops' turns);
# a depth tail inside a stage (K = 432, 864); the wide int16 loader and
# the gather loader at the new widths; yolov8m's Cin = 3 stem
PIPELINE_CASES = [
    (48, 48, 3, 1, (8, 64, 64), False, True),
    (96, 96, 3, 1, (2, 128, 128), False, True),
    (192, 288, 1, 1, (1, 160, 160), False, True),
    (192, 192, 3, 1, (4, 80, 80), False, True),
    (384, 384, 3, 2, (2, 21, 21), False, True),
    (576, 576, 3, 1, (1, 9, 11), False, True),
    (576, 576, 1, 1, (4, 80, 80), False, False),
    (64, 272, 3, 1, (2, 11, 13), False, True),
    (48, 96, 3, 2, (1, 9, 11), False, True),
    (96, 192, 1, 1, (1, 5, 5), False, True),
    (48, 48, 3, 1, (8, 64, 64), True, True),
    (96, 288, 1, 1, (1, 160, 160), True, True),
    (192, 192, 3, 1, (4, 80, 80), True, False),
    (3, 48, 3, 2, (4, 320, 320), False, True),
    (3, 16, 3, 2, (1, 64, 64), False, True),
    (24, 144, 3, 1, (2, 10, 10), True, True),
    (40, 80, 1, 1, (3, 12, 12), False, False),
]


@pytest.mark.parametrize("case", PIPELINE_CASES, ids=[
    f"{c[0]}-{c[1]}-k{c[2]}s{c[3]}-{'x'.join(map(str, c[4]))}"
    f"{'-wide' if c[5] else ''}{'' if c[6] else '-plain'}"
    for c in PIPELINE_CASES])
def test_conv_pipeline_tiles_equal_plain(cuda, case):
    cin, cout, k, stride, shape, wide, silu = case
    rng = np.random.default_rng(hash(case) % 2 ** 32)
    x, c = _random_conv(rng, cin, cout, k, stride, shape, wide, silu)
    sig = DeviceLut(sigmoid_lut(6.0, 8), cuda)
    _assert_conv_equals_plain(x, c, sig)


@pytest.mark.parametrize("model", ["yolov8n", "yolov8m", "yolov8m-p6"])
def test_conv_pipeline_every_conv_shape_of_the_benchmark_models(cuda, model):
    """Every conv of the model's graph at its published widths (small maps,
    B=2), on int8 input and, where Cin % 16 == 0, on wide int16 input: one
    launch each, on the loader its input takes, equal to conv_plain."""
    graph = build_yolov8_graph(QuantConfig(model=model, image_size=64))
    sig = DeviceLut(sigmoid_lut(6.0, 8), cuda)
    rng = np.random.default_rng(len(model))
    shapes = sorted({(n.cin, n.cout, n.kernel, n.stride, n.silu)
                     for n in graph.convs()})
    fused_ops.reset_counts()
    for cin, cout, k, stride, silu in shapes:
        for wide in (False, True) if cin % 16 == 0 else (False,):
            x, c = _random_conv(rng, cin, cout, k, stride, (2, 9, 7), wide,
                                silu)
            _assert_conv_equals_plain(x, c, sig)
    assert sum(fused_ops.LAUNCHES[k] for k in
               ("conv_vector", "conv_wide", "conv_gather")) \
        == fused_ops.LAUNCHES["conv1x1"] + fused_ops.LAUNCHES["conv3x3"]
    assert fused_ops.LAUNCHES["conv_gather"] == 1     # the Cin = 3 stem


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
    loader = fused_ops.conv_loader(x, 256)
    before = fused_ops.LAUNCHES[loader]
    got = fused_ops.conv3x3(x, c)
    want = fused_ops.conv_plain(x, c, None, 127)
    torch.cuda.synchronize()
    assert fused_ops.LAUNCHES[loader] == before + 1
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


GLUE_MODELS = [("yolov8n", 6, 13), ("yolov8m", 12, 13),
               ("yolov8m-p6", 14, 18)]


def _glue_values(rng, shape, dtype, device):
    """int8 over its whole range; int16 over +-3*qmax, then +-2^15 at the
    front (beyond any proof: the kernel must still wrap as the plain
    version does)."""
    if dtype == torch.int8:
        x = rng.integers(-128, 128, shape)
    else:
        x = rng.integers(-381, 382, shape)
        x.reshape(-1)[:4] = [32767, -32768, 381, -381]
    return torch.as_tensor(x, dtype=dtype, device=device)


@pytest.mark.parametrize("name,n_add,n_cat", GLUE_MODELS,
                         ids=[m[0] for m in GLUE_MODELS])
def test_glue_kernel_equals_plain_on_every_node(cuda, name, n_add, n_cat):
    """requant_combine_kernel against residual_add_plain / concat_plain on
    every add and concat node of the model at 64 px, B=2, the sources in
    their edges' dtypes and the model's own requants and clip; one launch
    a call."""
    from alpha_yolo_quant_torch.models.graph import (
        ConcatNode, ResidualAddNode, edge_shapes,
    )
    from alpha_yolo_quant_torch.parallel.pipeline import _edge_dtypes
    from alpha_yolo_quant_torch.runtime.interpreter import _store_dtype

    model = _card_model(model=name)
    shapes, dts = edge_shapes(model.graph, 64), _edge_dtypes(model)
    rq = {k: (int(v.rescale), int(v.shift))
          for k, v in model.requants.items()}
    rng = np.random.default_rng(5)

    def src(e):
        c, h, w = shapes[e]
        return _glue_values(rng, (2, h, w, c), dts[e], cuda)

    seen = {"glue_add": 0, "glue_concat": 0}
    for idx, node in enumerate(model.graph.nodes):
        if isinstance(node, ResidualAddNode):
            key = "glue_add"
            kernel = fused_ops.residual_add
            plain = fused_ops.residual_add_plain
            args = (src(node.src), src(node.base), *rq[(idx, node.src)], 127,
                    model.clip_after_residual.get(idx))
        elif isinstance(node, ConcatNode):
            key = "glue_concat"
            kernel, plain = fused_ops.concat, fused_ops.concat_plain
            args = ([src(e) for e in node.srcs],
                    [rq.get((idx, e)) for e in node.srcs], 127)
        else:
            continue
        dt = _store_dtype(model, node.dst)
        args += (dt,)
        before = fused_ops.LAUNCHES[key]
        got = kernel(*args)
        torch.cuda.synchronize()
        assert fused_ops.LAUNCHES[key] == before + 1
        want = plain(*args)
        assert got.dtype == want.dtype == dt and torch.equal(got, want), \
            node.dst
        seen[key] += 1
    assert (seen["glue_add"], seen["glue_concat"]) == (n_add, n_cat)


@pytest.mark.parametrize("out_dt", [torch.int8, torch.int16],
                         ids=["out8", "out16"])
def test_glue_kernel_ragged_widths_equal_plain(cuda, out_dt):
    """Widths that are no multiple of 16 take the scalar path: a concat of
    8 + 24 + 3 + 16 channels (the 16 after a ragged offset) and adds of 7
    and 20 channels, clipped and not. int8 and int16 mixed."""
    rng = np.random.default_rng(6)
    srcs = [_glue_values(rng, (2, 5, 3, c), dt, cuda)
            for c, dt in ((8, torch.int16), (24, torch.int8),
                          (3, torch.int8), (16, torch.int16))]
    reqs = [(201, 8), None, (77, 6), (150, 7)]
    before = fused_ops.LAUNCHES["glue_concat"]
    got = fused_ops.concat(srcs, reqs, 127, out_dt)
    torch.cuda.synchronize()
    assert fused_ops.LAUNCHES["glue_concat"] == before + 1
    assert torch.equal(got, fused_ops.concat_plain(srcs, reqs, 127, out_dt))
    for shape, bound in (((1, 3, 5, 7), None), ((1, 3, 5, 7), 127),
                         ((2, 4, 4, 20), 127)):
        x = _glue_values(rng, shape, torch.int16, cuda)
        base = _glue_values(rng, shape, torch.int8, cuda)
        before = fused_ops.LAUNCHES["glue_add"]
        got = fused_ops.residual_add(x, base, 231, 8, 127, bound, out_dt)
        torch.cuda.synchronize()
        assert fused_ops.LAUNCHES["glue_add"] == before + 1
        assert torch.equal(got, fused_ops.residual_add_plain(
            x, base, 231, 8, 127, bound, out_dt))


@pytest.mark.parametrize("name,n_add,n_cat", GLUE_MODELS,
                         ids=[m[0] for m in GLUE_MODELS])
def test_fused_forward_launches_one_glue_kernel_a_node(cuda, name, n_add,
                                                       n_cat):
    """A fused forward on the card launches requant_combine_kernel once per
    add and concat node (19 / 25 / 32) and gives the CPU forward's head
    edges bit for bit."""
    model = _card_model(model=name)
    x = np.random.default_rng(7).uniform(0, 1, (2, 3, 64, 64)).astype(
        np.float32)
    plan = device_plan(model, cuda)
    x_q = quantize_input(torch.as_tensor(x, device=cuda), 8)
    fused_ops.reset_counts()
    outs = int_forward(model, plan, x_q)
    torch.cuda.synchronize()
    assert (fused_ops.LAUNCHES["glue_add"],
            fused_ops.LAUNCHES["glue_concat"]) == (n_add, n_cat)
    outs_c = int_forward(model, device_plan(model, "cpu"),
                         quantize_input(torch.as_tensor(x), 8))
    for role in model.graph.outputs:
        assert torch.equal(outs[role].cpu(), outs_c[role]), role


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


@pytest.mark.parametrize("engine", ["fused", "pallas", "packed"])
def test_model_from_artifacts_on_card_equals_built(cuda, engine, tmp_path):
    """quantize -> export -> load back: the full-quant model loaded from
    its exported tree serves on the card, launching the engine's kernels,
    the same detections as the model built directly, bit for bit."""
    from alpha_yolo_quant_torch.export.artifacts import export_all
    from alpha_yolo_quant_torch.quantize.loadq import model_from_artifacts

    model = _card_model()
    x = np.random.default_rng(8).uniform(0, 1, (3, 3, 64, 64)).astype(
        np.float32)
    export_all(model, golden_forward(model, x[:1]),
               init_params(model.graph, seed=0), str(tmp_path),
               warn=lambda *a: None)
    loaded = model_from_artifacts(str(tmp_path), model.cfg)
    xt = torch.as_tensor(x, device=cuda)
    want = build_int_pipeline(model, cuda, engine=engine)[0](xt)
    fused_ops.reset_counts()
    got = build_int_pipeline(loaded, cuda, engine=engine)[0](xt)
    torch.cuda.synchronize()
    kernels = {"fused": ("conv1x1", "conv3x3"),
               "pallas": ("postconv_silu", "postconv_plain"),
               "packed": ("packed_conv",)}[engine]
    assert all(fused_ops.LAUNCHES[k] > 0 for k in kernels)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _card_dataset(tmp_path, monkeypatch, n_images=7, size=64):
    """A COCO-layout dataset of seeded arrays. The card's machine has no
    PIL, so both readers' image decode becomes a lookup of those arrays;
    batching, staging and the harness are the port's own."""
    import json

    from alpha_yolo_quant_torch.data import coco, prefetch

    rng = np.random.default_rng(12)
    images = [{"id": i, "file_name": f"{i:012d}.jpg", "height": 480,
               "width": 640} for i in range(n_images)]
    anns = [{"id": j + 1, "image_id": j % n_images, "category_id": j % 5 + 1,
             "iscrowd": 0,
             "bbox": [float(v) for v in rng.uniform(20, 200, 4)]}
            for j in range(3 * n_images)]
    path = tmp_path / "instances.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": c + 1}
                                               for c in range(80)]}))
    ds = coco.CocoValDataset(str(tmp_path / "images"), str(path))
    arrays = {s.path: rng.uniform(0, 1, (3, size, size)).astype(np.float32)
              for s in ds.samples}
    for mod in (coco, prefetch):
        monkeypatch.setattr(mod, "load_image_square",
                            lambda p, sz: arrays[p])
    return ds


def test_prefetch_stages_on_card_equal_sync_reader(cuda, tmp_path,
                                                   monkeypatch):
    """prefetch_batches with device=cuda: each batch is a float32 tensor
    on the card, copied from pinned memory on the consumer's stream, equal
    to data.coco.batches exactly; padded tail entries carry None."""
    from alpha_yolo_quant_torch.data.coco import batches
    from alpha_yolo_quant_torch.data.prefetch import prefetch_batches

    ds = _card_dataset(tmp_path, monkeypatch)
    want = list(batches(ds, 3, 64))
    got = list(prefetch_batches(ds, 3, 64, decode_workers=2, device=cuda))
    assert len(got) == len(want) == 3
    for (wi, ws), (gi, gs) in zip(want, got):
        assert gi.device.type == "cuda" and gi.dtype == torch.float32
        assert torch.equal(gi.cpu(), torch.as_tensor(wi))
        assert [s.image_id if s else None for s in ws] == \
            [s.image_id if s else None for s in gs]
    assert got[-1][1][-1] is None


def test_evaluate_prefetch_on_card_equals_sync(cuda, tmp_path, monkeypatch):
    """evaluate(prefetch=True) on the card gives the rows and mAP of
    prefetch=False, with the fused engine's kernels launched."""
    from alpha_yolo_quant_torch.eval.harness import evaluate
    from alpha_yolo_quant_torch.runtime.interpreter import eval_nms_params

    ds = _card_dataset(tmp_path, monkeypatch)
    model = _card_model()
    step = build_int_pipeline(model, cuda,
                              nms_params=eval_nms_params(model, 0.001))[0]
    want = evaluate(step, ds, 3, 64, device=cuda)
    fused_ops.reset_counts()
    got = evaluate(step, ds, 3, 64, prefetch=True, device=cuda)
    assert fused_ops.LAUNCHES["conv1x1"] + fused_ops.LAUNCHES["conv3x3"] \
        == 3 * len(model.graph.convs())
    assert got.n_images == want.n_images == len(ds)
    assert len(got.det_rows) > 0
    assert (got.det_rows, got.ann_rows, got.map50_95) == \
        (want.det_rows, want.ann_rows, want.map50_95)


@pytest.mark.parametrize("engine", ["fused", "pallas", "packed"])
def test_sparse_select_on_card_equals_dense(cuda, engine):
    """build_int_pipeline(sparse_select=True) on the card: the dense
    pipeline's detections bit for bit and its launches, with the top-1000
    default and with a cut to the top 32 of the 84 anchors."""
    import dataclasses

    from alpha_yolo_quant_torch.runtime.interpreter import eval_nms_params

    model = _card_model()
    x = torch.as_tensor(np.random.default_rng(3).uniform(
        0, 1, (3, 3, 64, 64)).astype(np.float32), device=cuda)
    nms = eval_nms_params(model, 0.001)
    for params in (None, dataclasses.replace(nms, pre_topk=32)):
        runs = []
        for sparse in (False, True):
            fn = build_int_pipeline(model, cuda, engine=engine,
                                    nms_params=params,
                                    sparse_select=sparse)[0]
            torch.cuda.synchronize()
            fused_ops.reset_counts()
            out = fn(x)
            torch.cuda.synchronize()
            runs.append((out, dict(fused_ops.LAUNCHES)))
        (want, n_want), c_want = runs[0]
        (got, n_got), c_got = runs[1]
        assert torch.equal(got, want) and torch.equal(n_got, n_want)
        assert c_got == c_want and sum(c_got.values()) > 0


def test_bench_fn_and_device_trace_on_card(cuda, tmp_path):
    """bench_fn times a conv kernel with CUDA events; device_trace's
    chrome trace holds that kernel's device events."""
    import json

    from alpha_yolo_quant_torch.utils.profiling import bench_fn, device_trace

    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.integers(-127, 128, (8, 40, 40, 64)),
                        dtype=torch.int8, device=cuda)
    c = fused_ops.conv_entry(rng.integers(-127, 128, (64, 64, 3, 3)),
                             rng.integers(-99, 99, 64), 1, 1, False, cuda)
    ms = bench_fn(fused_ops.conv3x3, x, c, iters=5, device=cuda)
    assert 0 < ms < 1000
    with device_trace(str(tmp_path)) as path:
        fused_ops.conv3x3(x, c)
        torch.cuda.synchronize()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" and "conv_wgmma" in e.get("name", "")
               for e in events)


def test_pp_and_sp_over_gloo_ranks_sharing_the_card(cuda):
    """Two gloo ranks on cuda:0 (NCCL refuses two ranks on one card): pp
    S=2 gives the unsharded head edges and sp=2 the unsharded
    with_nms=False preds, bit for bit; the kernels built here first, so
    the ranks load them."""
    import _torch_ranks
    from alpha_yolo_quant_torch.parallel.mesh import run_ranks
    from alpha_yolo_quant_torch.runtime import _build

    _build.build()
    model = _card_model()
    x = np.random.default_rng(5).uniform(0, 1, (4, 3, 64, 64)).astype(
        np.float32)
    got = run_ranks(_torch_ranks.card_checks, (model, x, 2), 2, "gloo",
                    deadline_s=300)
    plan = device_plan(model, cuda)
    heads = int_forward(model, plan, quantize_input(
        torch.as_tensor(x, device=cuda), 8))
    for role, t in heads.items():
        np.testing.assert_array_equal(got["pp2"][role], t.cpu().numpy())
    preds = build_int_pipeline(model, cuda, with_nms=False)[0](
        torch.as_tensor(x, device=cuda))
    np.testing.assert_array_equal(got["sp"], preds.cpu().numpy())


def test_dp_world_one_over_nccl(cuda):
    """One NCCL rank on the card serves the batch through the dp step
    and gather equal to the direct pipeline."""
    import _torch_ranks
    from alpha_yolo_quant_torch.parallel.mesh import run_ranks
    from alpha_yolo_quant_torch.runtime import _build

    _build.build()
    model = _card_model()
    x = np.random.default_rng(6).uniform(0, 1, (2, 3, 64, 64)).astype(
        np.float32)
    det, n = run_ranks(_torch_ranks.nccl_dp_checks, (model, x), 1, "nccl",
                       deadline_s=300)
    det_d, n_d = build_int_pipeline(model, cuda)[0](
        torch.as_tensor(x, device=cuda))
    np.testing.assert_array_equal(det, det_d.cpu().numpy())
    np.testing.assert_array_equal(n, n_d.cpu().numpy())


# the staged ingest (runtime/ingest.py): chunks of a prime byte count, so
# that the 64-px batches below cross many chunk and float32 boundaries
SMALL_CHUNK = 10_007


@functools.lru_cache(maxsize=1)
def _ingest_model():
    return _card_model()


def _host_batch(dtype, b, size=64, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, 3, size, size)
    if dtype == "uint8":
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.random(shape, dtype=np.float32)


def _chunks(x, chunk):
    return len(ingest.chunk_plan(x.nbytes, chunk))


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("b", [1, 3, 128])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_staged_ingest_equals_as_tensor_at_640(cuda, dtype, b, kind):
    """The ring at its own chunk size over 640-px host batches (B=128
    uint8 is 157,286,400 bytes, not a whole number of chunks): the device
    tensor of torch.as_tensor, one staged call counted with its chunks and
    bytes."""
    x = _host_batch(dtype, b, 640, seed=b)
    src = torch.from_numpy(x) if kind == "tensor" else x
    ingest.reset_counts()
    got = ingest.StagedIngest(cuda)(src)
    want = torch.as_tensor(src, device=cuda)
    assert (got.device, got.dtype, got.shape) == \
        (want.device, want.dtype, want.shape)
    assert torch.equal(got, want)
    assert ingest.STAGED == {"calls": 1,
                             "chunks": _chunks(x, ingest.CHUNK_BYTES),
                             "bytes": x.nbytes}


def test_device_input_passes_through_the_ingest(cuda):
    t = torch.arange(96, dtype=torch.uint8, device=cuda).reshape(2, 3, 4, 4)
    ingest.reset_counts()
    assert ingest.StagedIngest(cuda)(t) is t
    assert ingest.STAGED["calls"] == 0


@pytest.mark.parametrize("b", [1, 3, 128])
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_staged_pipeline_equals_device_input(cuda, monkeypatch, dtype, b):
    """fn on numpy and CPU-tensor batches gives the detections of fn on
    the same batch already on the card, bit for bit; only the host
    batches are staged."""
    monkeypatch.setattr(ingest, "CHUNK_BYTES", SMALL_CHUNK)
    fn = build_int_pipeline(_ingest_model(), cuda)[0]
    x = _host_batch(dtype, b, seed=b)
    ingest.reset_counts()
    det_w, n_w = fn(torch.as_tensor(x, device=cuda))
    assert ingest.STAGED["calls"] == 0
    for src in (x, torch.from_numpy(x)):
        det, n = fn(src)
        assert torch.equal(det, det_w) and torch.equal(n, n_w)
    assert int(n_w.sum()) > 0
    assert ingest.STAGED == {"calls": 2,
                             "chunks": 2 * _chunks(x, SMALL_CHUNK),
                             "bytes": 2 * x.nbytes}


def test_staged_coalesced_fn_equals_device_input(cuda, monkeypatch):
    """coalesce_requests=3: each host request staged on its own (one
    uint8 image, a float32 pair, five uint8 images)."""
    monkeypatch.setattr(ingest, "CHUNK_BYTES", SMALL_CHUNK)
    fn = build_int_pipeline(_ingest_model(), cuda, coalesce_requests=3)[0]
    reqs = [_host_batch("uint8", 1, seed=1), _host_batch("float32", 2, seed=2),
            _host_batch("uint8", 5, seed=3)]
    want = fn(*[torch.as_tensor(r, device=cuda) for r in reqs])
    ingest.reset_counts()
    got = fn(*reqs)
    for (det, n), (det_w, n_w) in zip(got, want):
        assert torch.equal(det, det_w) and torch.equal(n, n_w)
    assert ingest.STAGED["calls"] == 3
    assert ingest.STAGED["bytes"] == sum(r.nbytes for r in reqs)


def test_two_threads_calling_one_staged_fn(cuda, monkeypatch):
    """Two threads call one fn at once, ten times each, on batches of
    their own: every answer is the answer of that batch alone."""
    monkeypatch.setattr(ingest, "CHUNK_BYTES", SMALL_CHUNK)
    fn = build_int_pipeline(_ingest_model(), cuda)[0]
    xs = [_host_batch("uint8", 16, seed=s) for s in (21, 22)]
    wants = [tuple(t.cpu() for t in fn(torch.as_tensor(x, device=cuda)))
             for x in xs]
    ingest.reset_counts()
    start, wrong = threading.Barrier(2), []

    def worker(k):
        start.wait()
        for _ in range(10):
            det, n = fn(xs[k])
            if not (torch.equal(det.cpu(), wants[k][0])
                    and torch.equal(n.cpu(), wants[k][1])):
                wrong.append(k)
    threads = [threading.Thread(target=worker, args=(k,)) for k in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert wrong == []
    assert ingest.STAGED["calls"] == 20


def test_caller_overwrites_its_array_right_after_the_call(cuda, monkeypatch):
    """The caller's array is rewritten as soon as fn (or the ingest)
    returns, before the card has caught up: the answers are those of the
    bytes it handed in."""
    monkeypatch.setattr(ingest, "CHUNK_BYTES", SMALL_CHUNK)
    fn = build_int_pipeline(_ingest_model(), cuda)[0]
    x = _host_batch("uint8", 128, seed=31)
    keep = x.copy()
    det_w, n_w = fn(torch.as_tensor(keep, device=cuda))
    ingest.reset_counts()
    det, n = fn(x)
    x[...] = 255 - x
    assert torch.equal(det, det_w) and torch.equal(n, n_w)
    big = _host_batch("uint8", 128, 640, seed=32)
    keep = big.copy()
    got = ingest.StagedIngest(cuda)(big)
    big[...] = 0
    assert torch.equal(got, torch.as_tensor(keep, device=cuda))
    assert ingest.STAGED["calls"] == 2
