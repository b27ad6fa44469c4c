"""YOLO11 through the port on the CPU (no JAX): the graph's counts against
the published table at every scale, the port's head edges against
golden_forward and its detections against the benchmark's plain YOLO11
reference bit for bit, the depthwise and attention twins against int64
transcriptions, the attention alone at 400 pixels, the launch counts and
spans of a fused forward, and the refusals of the dense-only code.

The tests marked ``gpu`` hold the two kernels to their twins on the card,
at every yolo11m shape and B = 128; like tests/test_torch_gpu.py they
import nothing of JAX and run without the repo's conftest.py:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_yolo11.py
"""

import numpy as np
import pytest
import torch

from alpha_yolo_quant_torch.cli import build_parser
from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.export.artifacts import export_all
from alpha_yolo_quant_torch.hwsim.refmem import simulate_stage8_memory
from alpha_yolo_quant_torch.hwsim.sram import simulate
from alpha_yolo_quant_torch.models.graph import (
    AttentionNode, build_yolov8_graph, edge_shapes, node_costs,
)
from alpha_yolo_quant_torch.models.params import (
    init_params, load_raw_from_values,
)
from alpha_yolo_quant_torch.ops.lut import DeviceLut
from alpha_yolo_quant_torch.ops.nn import attention_f32
from alpha_yolo_quant_torch.parallel.mesh import tensor_parallel_fn
from alpha_yolo_quant_torch.parallel.pipeline import build_pipeline_spec
from alpha_yolo_quant_torch.quantize.luts import sigmoid_lut, unit_lut
from alpha_yolo_quant_torch.quantize.transform import (
    _attn_plan, build_quantized_model,
)
from alpha_yolo_quant_torch.runtime import fused_ops
from alpha_yolo_quant_torch.runtime.golden import attention_np, golden_forward
from alpha_yolo_quant_torch.runtime.interpreter import (
    build_int_pipeline, device_plan, int_forward, quantize_input,
)
from alpha_yolo_quant_torch.utils import profiling
from benchmark import inputs, program, run, spec

YOLO11 = ("yolo11n", "yolo11s", "yolo11m", "yolo11l", "yolo11x")
# ultralytics' published YOLO11 sizes: parameters (unfused: BN weight and
# bias, the head Conv2d biases, the DFL's 16) and GFLOPs at 640 px
PUBLISHED = {"yolo11n": (2_624_080, 6.5), "yolo11s": (9_458_752, 21.5),
             "yolo11m": (20_114_688, 68.0), "yolo11l": (25_372_160, 86.9),
             "yolo11x": (56_966_176, 194.9)}
NMS = {"conf_thres_int": 8192, "iou_thres": 0.45, "pre_topk": 1000,
       "max_det": 300, "max_wh": 7680.0}
REF = {"reference": "reference_yolo11"}


@pytest.fixture
def one_thread():
    """One intra-op torch thread: the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _config(model, size):
    return dict(REF, model=model, k=8, full_quant=True, image_size=size,
                koeff_bits=8, engine="fused", nms=NMS)


@pytest.mark.parametrize("model,seed", [("yolo11n", 11),
                                        ("yolo11m", 2 ** 31 + 13)])
def test_yolo11_heads_equal_golden_and_detections_the_reference(
        one_thread, model, seed):
    """At 128 px on the benchmark's seeded weights and calibration: the
    port's head edges equal golden_forward's, and the port's serving
    pipeline (benchmark/program.build) gives the plain YOLO11 reference's
    detections bit for bit."""
    size = 128
    config = _config(model, size)
    ref = spec.reference(config)
    graph = ref.graph.build_yolov8_graph(run.ref_cfg(config))
    seeds = inputs.Seeds(seed)
    params = inputs.make_params(graph, seeds, "cpu")
    max_a = inputs.make_max_a(ref, graph, params, seeds, 2, size, "cpu")
    images = inputs.make_pool(seeds, 2, size, "cpu")

    cfg = QuantConfig(model=model, k=8, full_quant=True, image_size=size)
    tmodel = build_quantized_model(build_yolov8_graph(cfg), params, max_a,
                                   cfg)
    x = images[:1].astype(np.float32) / np.float32(255.0)
    outs = int_forward(tmodel, device_plan(tmodel, "cpu"),
                       quantize_input(torch.as_tensor(images[:1]), 8))
    want = golden_forward(tmodel, x)
    for role in tmodel.graph.outputs:
        np.testing.assert_array_equal(outs[role].numpy().astype(np.int64),
                                      want[role], err_msg=role)

    det, n = program.build(config, params, max_a, "cpu")(images)
    rdet, rn = run.reference_fn(config, params, max_a, 8, "cpu")(images)
    assert n.sum() > 0
    np.testing.assert_array_equal(n.numpy(), rn.numpy())
    np.testing.assert_array_equal(det.numpy(), rdet.numpy())


def _sizes(graph, convs, shapes, heads):
    """(parameters, GFLOPs at 640) counted as ultralytics does: conv
    weights, BN's weight and bias on every Conv, a bias on each head
    Conv2d, the DFL's 16; 2 * conv MACs."""
    n = sum(c.cout * c.cin * c.kernel ** 2
            + (c.cout if c.name in heads else 2 * c.cout) for c in convs)
    macs = sum(c.cin * c.kernel ** 2 * np.prod(shapes[c.dst])
               for c in convs)
    return n + 16, round(2 * macs / 1e9, 1)


@pytest.mark.parametrize("model", YOLO11)
def test_yolo11_sizes_are_the_published_ones(model):
    """The port's graph and the reference's give ultralytics' parameter
    count and GFLOPs at each scale, and agree conv by conv on name, key,
    tap, out_tap, groups and shapes."""
    g = build_yolov8_graph(QuantConfig(model=model, full_quant=True))
    ref = spec.reference(REF)
    rg = ref.graph.build_yolov8_graph(ref.config.QuantConfig(model=model))
    shapes, rshapes = edge_shapes(g, 640), ref.graph.edge_shapes(rg, 640)
    heads = {g.head_conv(r) for r in g.outputs}
    assert _sizes(g, g.convs(), shapes, heads) == PUBLISHED[model]
    assert _sizes(rg, rg.convs(), rshapes, heads) == PUBLISHED[model]
    assert sum(node_costs(g, 640)) * 2 / 1e9 == pytest.approx(
        PUBLISHED[model][1], abs=0.05)

    def rows(graph, sh):
        return [(n.name, n.key, n.tap, n.out_tap, n.cin, n.cout, n.kernel,
                 n.stride, n.silu, n.groups, sh[n.src], sh[n.dst])
                for n in graph.convs()]

    assert rows(g, shapes) == rows(rg, rshapes)
    assert list(g.outputs) == list(rg.outputs)


def test_yolo11m_at_640():
    """112 convs (105 dense, 7 depthwise: two a cls branch and the pe),
    20,068,288 conv weights, 33.99 GMAC, Couts 32-512; one attention over
    the 20 x 20 P5 map, 4 heads of key_dim 32 and head_dim 64, 61.4 M
    MACs an image."""
    g = build_yolov8_graph(QuantConfig(model="yolo11m", full_quant=True))
    convs = g.convs()
    dw = [n.name for n in convs if n.groups > 1]
    assert (len(convs), len(dw)) == (112, 7)
    assert sorted(dw) == sorted(
        ["C2PSA_10_m0_pe"] + [f"Detect_{lv}_cls_{j}"
                              for lv in ("p3", "p4", "p5") for j in (0, 2)])
    assert sum(n.cout * n.cin * n.kernel ** 2 for n in convs) == 20_068_288
    assert sum(node_costs(g, 640)) == 33_990_246_400
    assert {n.cout for n in convs} == {32, 64, 80, 128, 256, 512}
    assert [n.name for n in convs if n.requant_out] == [
        "C2PSA_10_m0_qkv", "C2PSA_10_m0_pe", "C2PSA_10_m0_proj",
        "C2PSA_10_m0_ffn1"]
    (a,) = g.attentions()
    shapes = edge_shapes(g, 640)
    n = shapes[a.src][1] * shapes[a.src][2]
    assert (a.heads, a.key_dim, a.head_dim, n) == (4, 32, 64, 400)
    assert a.heads * n * n * (a.key_dim + a.head_dim) == 61_440_000


def _rq(v, m, s, qmax):
    q = (np.int64(m) * v) >> (np.int64(s) - 1)
    return np.clip((q >> 1) + (q & 1), -qmax, qmax)


def _dw_acc(x, w, b):
    """Depthwise 3x3, pad 1, tap by tap in int64 over NHWC."""
    bb, h, ww, c = x.shape
    xp = np.pad(np.int64(x), ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((bb, h, ww, c), np.int64) + b
    for dy in range(3):
        for dx in range(3):
            acc += xp[:, dy:dy + h, dx:dx + ww] * np.int64(w[:, 0, dy, dx])
    return acc


def _dwconv_int64(x, w, b, r1, s1, r2, s2, sig, qmax):
    """_dw_acc, then the SiLU epilogue in int64."""
    acc = _dw_acc(x, w, b)
    dom = _rq(acc, r1, s1, qmax)
    sigma = np.int64(sig.values)[dom - sig.lo]
    return _rq(acc, sigma * r2, s2, qmax)


@pytest.mark.parametrize("table", ["sigmoid", "unit"])
def test_dwconv_twin_is_its_int64_transcription(table):
    """dwconv3x3 on CPU tensors (its twin) equals the transcription, with
    the sigmoid table and with the table of ones, where it is the plain
    requant clip(rhu(r2 * acc >> (s2 - 1)))."""
    rng = np.random.default_rng(4)
    c = 48
    x = rng.integers(-127, 128, (2, 7, 9, c))
    w = rng.integers(-127, 128, (c, 1, 3, 3))
    b = rng.integers(-3000, 3000, c)
    r1, s1 = rng.integers(1, 256, c), rng.integers(12, 18, c)
    r2, s2 = rng.integers(1, 256, c), rng.integers(18, 26, c)
    lut = sigmoid_lut(6.0, 8)
    want = _dwconv_int64(x, w, b, r1, s1, r2, s2, lut, 127)
    if table == "unit":
        lut = unit_lut(8)
        s2 = s2 - 6
        want = _rq(_dw_acc(x, w, b), r2, s2, 127)
        r1, s1, r2, s2 = fused_ops.requant_consts(r2, s2)
    ent = fused_ops.dwconv_entry(w, b, "cpu", r1, s1, r2, s2)
    got = fused_ops.dwconv3x3(torch.as_tensor(x, dtype=torch.int8), ent,
                              DeviceLut(lut, "cpu"), 127)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)


def _attention_int64(qkv, heads, a, qmax):
    """The attention contract image by image and head by head in int64
    over NHWC qkv: (out, v), NHWC, channel h * 64 + d."""
    bb, h, w, _ = qkv.shape
    t = np.int64(qkv).reshape(bb, h * w, heads, 128)
    out = np.zeros((bb, h * w, heads, 64), np.int64)
    exp = np.int64(a.exp_lut.values)
    for i in range(bb):
        for j in range(heads):
            q, k, v = t[i, :, j, :32], t[i, :, j, 32:64], t[i, :, j, 64:]
            lq = _rq(q @ k.T, a.logit_r, a.logit_s, 127)
            e = exp[lq - lq.max(axis=1, keepdims=True) + 255]
            o = (e @ v) // e.sum(axis=1, keepdims=True)
            out[i, :, j] = _rq(o, a.out_r, a.out_s, qmax)
    return (out.reshape(bb, h, w, heads * 64),
            t[..., 64:].reshape(bb, h, w, heads * 64))


def _attn_case(seed, heads, hw, amax=4.0, k=8):
    """Seeded int8 qkv (B = 2 unless hw is 20) and the AttnPlan the
    transform derives from the float attention of its values."""
    rng = np.random.default_rng(seed)
    b = 1 if hw == (20, 20) else 2
    qkv = rng.integers(-127, 128, (b,) + hw + (heads * 128,))
    node = AttentionNode("att", "qkv", "out", "v", heads, 32, 64, "logits",
                         "att")
    s = 127 / amax
    x = torch.as_tensor(qkv, dtype=torch.float64).permute(0, 3, 1, 2) / s
    logits, out, _ = attention_f32(x, heads, 32, 64)
    max_a = {"logits": float(logits.abs().max()),
             "att": float(out.abs().max())}
    cfg = QuantConfig(model="yolo11m", k=k, full_quant=True)
    return qkv, _attn_plan(node, s, max_a, cfg)


@pytest.mark.parametrize("heads,hw", [(2, (3, 4)), (4, (5, 7))])
def test_attention_twin_is_its_int64_transcription(heads, hw):
    """fused_ops.attention on CPU tensors (its twin) equals the
    image-by-image, head-by-head transcription, and golden's
    attention_np, on ragged maps."""
    qkv, a = _attn_case(7 + heads, heads, hw)
    ent = fused_ops.attn_entry(a, "cpu")
    out, v = fused_ops.attention(torch.as_tensor(qkv, dtype=torch.int8),
                                 ent, 127)
    want, want_v = _attention_int64(qkv, heads, a, 127)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(v.numpy(), want_v)
    g_out, g_v = attention_np(a, np.int64(qkv).transpose(0, 3, 1, 2), 8)
    np.testing.assert_array_equal(g_out.transpose(0, 2, 3, 1), want)
    np.testing.assert_array_equal(g_v.transpose(0, 2, 3, 1), want_v)


def test_attention_node_alone_at_400_pixels():
    """yolo11m's attention at its 640-px map, 4 heads over 400 pixels, on
    seeded int8 q, k, v: the twin equals the transcription, and the
    output, normalised after the product, is mostly non-zero where a
    7-bit probability of each pixel would be 0 (a flat softmax over 400
    pixels gives each at most 127 / 400 < 1)."""
    qkv, a = _attn_case(3, 4, (20, 20))
    out, _ = fused_ops.attention(torch.as_tensor(qkv, dtype=torch.int8),
                                 fused_ops.attn_entry(a, "cpu"), 127)
    want, _ = _attention_int64(qkv, 4, a, 127)
    np.testing.assert_array_equal(out.numpy(), want)
    assert (want != 0).mean() > 0.5


@pytest.fixture(scope="module")
def yolo11n_64():
    """yolo11n at 64 px on random weights: (model, params)."""
    cfg = QuantConfig(model="yolo11n", k=8, full_quant=True, image_size=64)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=1)
    max_a = {n.tap: 4.0 for n in graph.convs()}
    for a in graph.attentions():
        max_a.update({a.tap: 2.0, a.out_tap: 1.0})
    return build_quantized_model(graph, params, max_a, cfg), params


def test_a_fused_forward_launches_and_spans(one_thread, monkeypatch):
    """One fused yolo11m forward calls 105 dense conv kernels, 7 depthwise
    and 1 attention (counted through wrappers: on the CPU the kernels'
    twins run), each depthwise conv inside its ``ayq.forward.conv.<layer>``
    span and the attention inside ``ayq.forward.attn.<node>``."""
    cfg = QuantConfig(model="yolo11m", k=8, full_quant=True, image_size=64)
    graph = build_yolov8_graph(cfg)
    max_a = {n.tap: 4.0 for n in graph.convs()}
    for a in graph.attentions():
        max_a.update({a.tap: 2.0, a.out_tap: 1.0})
    model = build_quantized_model(graph, init_params(graph, seed=2), max_a,
                                  cfg)
    calls = {"conv1x1": 0, "conv3x3": 0, "dwconv3x3": 0, "attention": 0}
    for name in calls:
        fn = getattr(fused_ops, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)
        monkeypatch.setattr(fused_ops, name, counted)
    x = torch.randint(0, 256, (1, 3, 64, 64), dtype=torch.uint8)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        int_forward(model, device_plan(model, "cpu"), quantize_input(x, 8))
    assert calls["conv1x1"] + calls["conv3x3"] == 105
    assert (calls["dwconv3x3"], calls["attention"]) == (7, 1)
    names = [e.name for e in prof.events()]
    assert names.count("ayq.forward.attn.C2PSA_10_m0_attn") == 1
    for n in graph.convs():
        if n.groups > 1:
            assert names.count(f"ayq.forward.conv.{n.name}") == 1
    assert "ayq.forward.attn." in profiling.SPANS


@pytest.mark.parametrize("what", ["export", "hwsim", "sram", "checkpoint",
                                  "pallas", "packed", "pipeline", "tensor"])
def test_the_dense_only_code_refuses_yolo11(tmp_path, yolo11n_64, what):
    """The Verilog tree, the SRAM schedule and allocator, the checkpoint
    remap, the nibble-split and slab engines, the pp pipeline and the tensor-parallel
    forward have no depthwise conv and no attention: each refuses a
    YOLO11 model with an error that says so, and writes nothing."""
    model, params = yolo11n_64
    out = tmp_path / "tree"
    with pytest.raises(ValueError, match="7 depthwise convs and 1 attention"):
        if what == "export":
            export_all(model, {}, params, str(out))
        elif what == "hwsim":
            simulate_stage8_memory(model.graph, 64)
        elif what == "sram":
            simulate(model.graph, 64)
        elif what == "checkpoint":
            load_raw_from_values(model.graph, [])
        elif what in ("pallas", "packed"):
            build_int_pipeline(model, "cpu", engine=what)
        elif what == "pipeline":
            build_pipeline_spec(model, 2, 1, 2)
        else:
            tensor_parallel_fn(model.graph, None)
    assert not out.exists()


def test_the_cli_takes_the_yolo11_models():
    """``--model`` takes every YOLO11 name, and the artifact directory
    names the YOLO11 graph."""
    for model in YOLO11:
        args = build_parser().parse_args(["info", "--model", model])
        assert args.model == model
    assert QuantConfig(model="yolo11m").main_dir_name == "8_medium_yolo11"
    assert QuantConfig(model="yolo11m").max_channels == 512
    assert QuantConfig(model="yolo11x").detect_cls_channels == 384


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_dwconv_at_every_yolo11m_shape(cuda):
    """dwconv3x3 against its twin (max|diff| 0) at each of yolo11m's seven
    depthwise convs at 640 px and B = 128, one launch each, the pe with
    the table of ones."""
    g = build_yolov8_graph(QuantConfig(model="yolo11m", full_quant=True))
    shapes = edge_shapes(g, 640)
    rng = np.random.default_rng(5)
    sig, unit = (DeviceLut(t, cuda) for t in (sigmoid_lut(6.0, 8),
                                              unit_lut(8)))
    for n in g.convs():
        if n.groups == 1:
            continue
        c, h, w = shapes[n.src]
        x = torch.randint(-127, 128, (128, h, w, c), dtype=torch.int8,
                          device=cuda)
        consts = (rng.integers(1, 256, c), rng.integers(12, 18, c),
                  rng.integers(1, 256, c), rng.integers(18, 26, c))
        if n.requant_out:
            consts = fused_ops.requant_consts(consts[2], consts[3] - 6)
        ent = fused_ops.dwconv_entry(rng.integers(-127, 128, (c, 1, 3, 3)),
                                     rng.integers(-3000, 3000, c), cuda,
                                     *consts)
        lut = unit if n.requant_out else sig
        before = fused_ops.LAUNCHES["dwconv"]
        got = fused_ops.dwconv3x3(x, ent, lut, 127)
        torch.cuda.synchronize()
        assert fused_ops.LAUNCHES["dwconv"] == before + 1
        assert torch.equal(got, fused_ops.dwconv3x3_plain(x, ent, lut, 127)), \
            n.name


@pytest.mark.gpu
def test_card_attention_at_b128(cuda):
    """attention against its twin (max|diff| 0) at yolo11m's shape, B =
    128 images drawn independently over 400 pixels (so a block that reads
    or writes another image's slab shows), and on two ragged 7 x 9
    maps."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    for seed, batch, hw in ((3, 128, (20, 20)), (4, 2, (7, 9))):
        qkv, a = _attn_case(seed, 4, hw)
        x = torch.randint(-127, 128, (batch,) + hw + (4 * 128,),
                          dtype=torch.int8, device=cuda, generator=gen)
        x[:qkv.shape[0]] = torch.as_tensor(qkv, dtype=torch.int8)
        ent = fused_ops.attn_entry(a, cuda)
        before = fused_ops.LAUNCHES["attn"]
        out, v = fused_ops.attention(x, ent, 127)
        torch.cuda.synchronize()
        assert fused_ops.LAUNCHES["attn"] == before + 1
        pout, pv = fused_ops.attention_plain(x, ent, 127)
        assert torch.equal(out, pout) and torch.equal(v, pv)
        assert not torch.equal(out[0], out[-1])


@pytest.mark.gpu
def test_card_yolo11m_forward_counts_and_plain(cuda):
    """A fused yolo11m forward at 640 px on the card: 105 conv_wgmma, 7
    dwconv and 1 attn launches, head edges equal to the plain run's."""
    cfg = QuantConfig(model="yolo11m", k=8, full_quant=True)
    graph = build_yolov8_graph(cfg)
    max_a = {n.tap: 4.0 for n in graph.convs()}
    for a in graph.attentions():
        max_a.update({a.tap: 2.0, a.out_tap: 1.0})
    model = build_quantized_model(graph, init_params(graph, seed=3), max_a,
                                  cfg)
    plan = device_plan(model, cuda)
    x = quantize_input(torch.randint(0, 256, (2, 3, 640, 640),
                                     dtype=torch.uint8, device=cuda), 8)
    fused_ops.reset_counts()
    outs = int_forward(model, plan, x)
    torch.cuda.synchronize()
    n = fused_ops.LAUNCHES
    assert (n["conv1x1"] + n["conv3x3"], n["dwconv"], n["attn"]) == \
        (105, 7, 1)
    plain = int_forward(model, plan, x, plain=True)
    for role in graph.outputs:
        assert torch.equal(outs[role], plain[role]), role
