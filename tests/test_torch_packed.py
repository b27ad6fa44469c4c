"""The port's lane-packed banded conv (runtime/packed_conv.py: the plain
version of the K6 kernel, as it runs on the CPU) against the JAX package's
numpy oracle packed_conv_np and its plain-XLA twin, on the shapes of
tests/test_packed_conv.py; and the port's slab planner against JAX's.
Bit-exact (tolerance 0)."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

from alpha_yolo_quant_tpu.quantize.luts import sigmoid_lut as j_sigmoid_lut
from alpha_yolo_quant_tpu.runtime import packed_conv as jpc
from alpha_yolo_quant_tpu.runtime.slabforward import (
    build_slab_plan as j_build_slab_plan,
)
from alpha_yolo_quant_torch.ops.lut import DeviceLut
from alpha_yolo_quant_torch.quantize.luts import sigmoid_lut
from alpha_yolo_quant_torch.runtime import packed_conv as pc
from alpha_yolo_quant_torch.runtime.slabforward import build_slab_plan
from test_torch_gpu import PACKED_EDGES, block_sparse, packed_edge_case
from test_torch_model_build import assert_same, build_pair

RNG = np.random.default_rng(3)
SIG = DeviceLut(sigmoid_lut(6.0, 8), "cpu")


def _nhwc(x):
    return torch.as_tensor(x.transpose(0, 2, 3, 1).copy())


def _lanes(plan, cout, silu):
    """bias, r1, s1, r2, s2 lanes: raw (r=0, s=1) or SiLU constants that
    spread the int8 outputs; unused lanes carry r=0, s=1."""
    bias = pc.pack_lane_const(RNG.integers(-900, 900, cout), plan)
    if not silu:
        z = pc.pack_lane_const(np.zeros(cout), plan)
        o = pc.pack_lane_const(np.ones(cout), plan, fill=1)
        return bias, z, o, z, o
    r1, r2 = RNG.integers(64, 256, cout), RNG.integers(64, 256, cout)
    s1 = RNG.integers(18, 22, cout)
    s2 = s1 + 7
    return (bias, pc.pack_lane_const(r1, plan),
            pc.pack_lane_const(s1, plan, fill=1), pc.pack_lane_const(r2, plan),
            pc.pack_lane_const(s2, plan, fill=1))


@pytest.fixture(scope="module")
def jax_corrections():
    from alpha_yolo_quant_tpu.runtime.pallas_ops import (
        pallas_sigma_corrections,
    )

    return pallas_sigma_corrections(j_sigmoid_lut(6.0, 8))


def _jkw(silu, corrections):
    return dict(silu=silu, sig_scale=float(127 / SIG.lut.max_val),
                sig_qmax=127.0, corrections=corrections)


def _weights(cin, cout, kernel):
    w = RNG.integers(-127, 128, (cout, cin, kernel, kernel)).astype(np.int64)
    if kernel == 1:
        w33 = np.zeros((cout, cin, 3, 3), np.int64)
        w33[:, :, 1, 1] = w[:, :, 0, 0]
        w = w33
    return w


def _assert_equals_oracle(out, x, mats, plan, hw, bias_lane):
    """The unpacked output equals the numpy int64 oracle packed_conv_np
    over the padded slab, plus the bias."""
    h_out = hw // plan.stride
    back = pc.unpack_tensor(out, plan, h_out).permute(0, 3, 1, 2)
    oracle = jpc.unpack_tensor_np(
        jpc.packed_conv_np(jpc.pack_tensor_np(x, plan), mats, plan, hw),
        plan, h_out)
    np.testing.assert_array_equal(
        back.numpy().astype(np.int64),
        oracle + bias_lane[:plan.cout].reshape(1, -1, 1, 1))


@pytest.mark.parametrize("cin,cout,hw,kernel,silu",
                         [(16, 16, 32, 3, False), (32, 32, 16, 3, False),
                          (16, 16, 32, 1, False), (80, 80, 16, 3, False),
                          (32, 32, 16, 3, True)])
def test_packed_stride1_equals_jax(cin, cout, hw, kernel, silu,
                                   jax_corrections):
    plan = pc.make_plan(cin, cout, 1, hw)
    assert_same(plan, jpc.make_plan(cin, cout, 1, hw))
    x = RNG.integers(-127, 128, (2, cin, hw, hw)).astype(np.int64)
    w = _weights(cin, cout, kernel)
    mats = pc.packed_weight_mats(w, plan)
    np.testing.assert_array_equal(mats, jpc.packed_weight_mats(w, plan))
    lanes = _lanes(plan, cout, silu)
    slab = pc.pack_tensor(_nhwc(x), plan)
    jslab = jpc.pack_tensor_jnp(jnp.asarray(x, jnp.int32), plan)
    np.testing.assert_array_equal(slab.numpy(), np.asarray(jslab))
    out = pc.packed_conv_slab(slab, mats, *lanes, plan, hw, sig=SIG,
                              silu=silu)
    want = jpc.packed_conv_slab(jslab, mats, *lanes, plan, hw,
                                **_jkw(silu, jax_corrections))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    if silu:
        assert len(np.unique(out.numpy())) > 20, "constants must spread"
    else:
        _assert_equals_oracle(out, x, mats, plan, hw, lanes[0])


@pytest.mark.parametrize("cin,cout,hw,silu", [(16, 32, 32, False),
                                              (32, 64, 16, False),
                                              (64, 128, 16, False),
                                              (16, 32, 32, True)])
def test_packed_stride2_equals_jax(cin, cout, hw, silu, jax_corrections):
    """The even/odd row-block de-interleave (Conv_P2/P3/P4 shapes)."""
    plan = pc.make_plan(cin, cout, 2, hw)
    x = RNG.integers(-127, 128, (2, cin, hw, hw)).astype(np.int64)
    w = _weights(cin, cout, 3)
    mats = pc.packed_weight_mats(w, plan)
    lanes = _lanes(plan, cout, silu)
    sa, sb = pc.pack_tensor_s2(_nhwc(x), plan)
    ja, jb = jpc.pack_tensor_s2_jnp(jnp.asarray(x, jnp.int32), plan)
    np.testing.assert_array_equal(sa.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(sb.numpy(), np.asarray(jb))
    out = pc.packed_conv_s2(sa, sb, mats, *lanes, plan, hw, sig=SIG,
                            silu=silu)
    want = jpc.packed_conv_s2(ja, jb, mats, *lanes, plan, hw,
                              **_jkw(silu, jax_corrections))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))
    if not silu:
        _assert_equals_oracle(out, x, mats, plan, hw, lanes[0])


def test_packed_wide_two_part_equals_jax():
    """Wide inputs (|x| up to 254): x = x1 + x2, both slabs conv'd by the
    same taps and summed in the accumulator."""
    cin = cout = 16
    hw = 32
    plan = pc.make_plan(cin, cout, 1, hw)
    x = RNG.integers(-254, 255, (2, cin, hw, hw)).astype(np.int64)
    mats = pc.packed_weight_mats(_weights(cin, cout, 3), plan)
    lanes = _lanes(plan, cout, False)
    x1 = np.clip(x, -127, 127)
    s1, s2 = pc.pack_tensor(_nhwc(x1), plan), pc.pack_tensor(_nhwc(x - x1),
                                                             plan)
    out = pc.packed_conv_slab(s1, mats, *lanes, plan, hw, silu=False,
                              x_slab2=s2)
    want = jpc.packed_conv_slab(
        jpc.pack_tensor_jnp(jnp.asarray(x1, jnp.int32), plan), mats, *lanes,
        plan, hw, silu=False,
        x_slab2=jpc.pack_tensor_jnp(jnp.asarray(x - x1, jnp.int32), plan))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.mark.parametrize("cin,cout,hw,parts,silu",
                         [(48, 32, 32, 1, False), (96, 64, 16, 1, False),
                          (128, 64, 16, 1, False), (48, 32, 32, 3, False),
                          (96, 64, 16, 3, True)])
def test_packed_down2_equals_jax(cin, cout, hw, parts, silu,
                                 jax_corrections):
    """1x1 downpack (C2F_*_conv_1 shapes); parts=3 is the wide concat
    input (|x| up to 381) as three int8 part-pairs."""
    plan = pc.make_down2_plan(cin, cout, hw)
    assert_same(plan, jpc.make_down2_plan(cin, cout, hw))
    amax = 127 * parts
    x = RNG.integers(-amax, amax + 1, (2, cin, hw, hw)).astype(np.int64)
    w = RNG.integers(-127, 128, (cout, cin, 1, 1)).astype(np.int64)
    mats = pc.down2_weight_mats(w, plan)
    np.testing.assert_array_equal(mats, jpc.down2_weight_mats(w, plan))
    lanes = _lanes(plan, cout, silu)
    slabs, jslabs, rem = [], [], x
    for _ in range(parts):
        part = np.clip(rem, -127, 127)
        rem = rem - part
        slabs += list(pc.pack_tensor_down2(_nhwc(part), plan))
        jslabs += list(jpc.pack_tensor_down2_jnp(jnp.asarray(part, jnp.int32),
                                                 plan))
    for s, js in zip(slabs, jslabs):
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    out = pc.packed_conv_down2(slabs, mats, *lanes, plan, hw, sig=SIG,
                               silu=silu)
    want = jpc.packed_conv_down2(jslabs, mats, *lanes, plan, hw,
                                 **_jkw(silu, jax_corrections))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


def test_pack_unpack_roundtrip():
    plan = pc.make_plan(32, 32, 1, 16)
    x = RNG.integers(-127, 128, (3, 16, 16, 32))
    slab = pc.pack_tensor(torch.as_tensor(x), plan)
    assert slab.shape == (3, pc.slab_rows_ext(plan, 16), 128)
    np.testing.assert_array_equal(pc.unpack_tensor(slab, plan, 16).numpy(),
                                  x)


def test_packed_call_rejects_taps_outside_the_slab():
    plan = pc.make_plan(16, 16, 1, 32)
    slab = torch.zeros((1, pc.slab_rows_ext(plan, 32), 128),
                       dtype=torch.int8)
    e = pc.packed_entry([np.zeros((128, 128), np.int8)], *_lanes(plan, 16,
                                                                  False),
                        False, "cpu")
    m = 32 * (plan.g + 2)
    with pytest.raises(ValueError):
        pc._check_packed([slab], [(0, 0, slab.shape[1] - m + 1)], e, m,
                         None, 127)
    with pytest.raises(ValueError):
        pc._check_packed([slab], [(0, 1, 0)], e, m, None, 127)
    pc._check_packed([slab], [(0, 0, slab.shape[1] - m)], e, m, None, 127)


def test_packed_weights_layout():
    """The kernel's B operand: the kept k32 x n16 blocks of each W_t, in
    bit order, as (N, K) K-major 16-byte depth planes, [i, p, n, j] =
    W[32 kc + 16 p + j, 16 nc + n]; round trip to the matrices."""
    wl = [RNG.integers(-127, 128, (128, 128)).astype(np.int8),
          np.zeros((128, 128), np.int8), block_sparse(RNG, 0.3)[0]]
    masks = pc.block_masks(wl)
    wb = pc.kept_block_weights(wl, masks)
    n = [bin(m).count("1") for m in masks]
    assert wb.shape == (sum(n), 2, 16, 16) and wb.dtype == np.int8
    assert n[:2] == [32, 0] and wb.flags.c_contiguous
    np.testing.assert_array_equal(wb[9, 1, 3], wl[0][48:64, 16 + 3])
    np.testing.assert_array_equal(_weights_from_blocks(wb, masks),
                                  np.stack(wl))
    e = pc.packed_entry(wl, *_lanes(pc.make_plan(16, 16, 1, 32), 16, False),
                        False, "cpu")
    assert e["block_start"] == (0, 32, 32)
    np.testing.assert_array_equal(
        _weights_from_blocks(e["w_blocks"].numpy(), e["masks"]),
        e["w_f64"].numpy())


def _weights_from_blocks(wb, masks):
    """Kept blocks (n, 2, 16, 16) and masks -> (T, 128, 128) W[k, n]."""
    w = np.zeros((len(masks), 128, 128), np.int8)
    i = 0
    for t, mask in enumerate(masks):
        for bit in range(32):
            if mask >> bit & 1:
                kc, nc = divmod(bit, 8)
                w[t, 32 * kc:32 * kc + 32, 16 * nc:16 * nc + 16] = \
                    wb[i].transpose(0, 2, 1).reshape(32, 16)
                i += 1
    assert i == len(wb)
    return w


def masked_call_np(x_slabs, taps, e, gp2, h_out, sig, qmax=127):
    """Numpy emulation of the Hopper kernel through its launch plan: per
    128-row tile and tap group, a shared-memory byte array that starts as
    noise, the regions' depth planes and the kept blocks copied in where
    the plan puts them, and one int64 k32 x n16 product per set mask bit,
    read through the tap's A address and plane stride and the block's
    place; pieces outside ``live`` written as zeros without an epilogue;
    zero pad-group, head and tail rows."""
    m = h_out * gp2
    head = pc.FRONT_PAD + gp2
    r_out_ext = pc.rows_ext(h_out + 2, gp2)
    b = x_slabs[0].shape[0]
    lp = pc.launch_plan(taps, e)
    xs = [x.numpy() for x in x_slabs]
    wb = e["w_blocks"].numpy().reshape(-1)
    noise = np.random.default_rng(0)
    rows = np.arange(pc.TILE_ROWS)[:, None] * 16 + np.arange(16)
    acc = np.zeros((b, r_out_ext + pc.TILE_ROWS, 128), np.int64)
    for o0 in range(0, r_out_ext, pc.TILE_ROWS):
        r0 = o0 - head
        if r0 + pc.TILE_ROWS <= 0 or r0 >= m:
            continue
        t0 = reg0 = cp0 = 0
        for t_end, reg_end, cp_end in lp["groups"]:
            smem = noise.integers(-128, 128, (b, lp["group_bytes"]),
                                  dtype=np.int8)
            for si, lo, n, off, kmask in lp["regions"][reg0:reg_end]:
                idx = r0 + lo + np.arange(n)
                ok = (idx >= 0) & (idx < xs[si].shape[1])
                a = np.zeros((b, n, 128), np.int8)
                a[:, ok] = xs[si][:, idx[ok]]
                planes = a.reshape(b, n, 8, 16).transpose(0, 2, 1, 3)
                for kc in range(8):
                    if kmask >> (kc // 2) & 1:
                        smem[:, off + kc * n * 16:off + (kc + 1) * n * 16] = \
                            planes[:, kc].reshape(b, -1)
            for src, n, dst in lp["copies"][cp0:cp_end]:
                smem[:, dst:dst + n * pc.BLOCK_BYTES] = \
                    wb[src * pc.BLOCK_BYTES:(src + n) * pc.BLOCK_BYTES]
            for a_off, lbo, b_off, mask in lp["taps"][t0:t_end]:
                mask = int(mask) & 0xFFFFFFFF
                for bit in range(32):
                    if not mask >> bit & 1:
                        continue
                    kc, nc = divmod(bit, 8)
                    a = np.concatenate(
                        [smem[:, a_off + (2 * kc + p) * lbo + rows]
                         for p in range(2)], axis=2).astype(np.int64)
                    blk = b_off + bin(mask & ((1 << bit) - 1)).count("1") \
                        * pc.BLOCK_BYTES
                    w = smem[0, blk:blk + pc.BLOCK_BYTES].reshape(2, 16, 16)
                    acc[:, o0:o0 + pc.TILE_ROWS, 16 * nc:16 * nc + 16] += \
                        a @ w.transpose(0, 2, 1).reshape(32, 16).astype(
                            np.int64)
            t0, reg0, cp0 = t_end, reg_end, cp_end
    acc = acc[:, head:head + m] + e["b"].numpy()
    out = (pc.fused_ops.silu_epilogue_plain(torch.as_tensor(acc), e, sig,
                                            qmax).numpy()
           if e["silu"] else acc.astype(np.int32))
    live = np.repeat([e["live"] >> nc & 1 for nc in range(8)], 16)
    u = np.arange(m) % gp2
    out = out * live * ((u >= 1) & (u <= gp2 - 2))[:, None]
    full = np.zeros((b, r_out_ext, 128), out.dtype)
    full[:, head:head + m] = out
    return full


def test_launch_plan_groups_fit():
    """Taps whose regions and kept blocks pass GROUP_BYTES split into
    groups in order, each within it; a region spans its taps' bases."""
    x_slabs, taps, e, gp2, h_out, _ = packed_edge_case("limits", False, "cpu")
    lp = pc.launch_plan(taps, e)
    assert lp is pc.launch_plan(taps, e)
    assert len(lp["groups"]) > 1 and lp["group_bytes"] <= pc.GROUP_BYTES
    assert lp["groups"][-1].tolist() == [32, len(lp["regions"]),
                                         len(lp["copies"])]
    t0 = reg0 = 0
    for t_end, reg_end, _ in lp["groups"]:
        group = taps[t0:t_end]
        assert pc._group_bytes(group, e["masks"]) <= pc.GROUP_BYTES
        for si, lo, n, _, _ in lp["regions"][reg0:reg_end]:
            bases = [b for s, _, b in group if s == si]
            assert lo == min(bases) and n == 128 + max(bases) - lo
        t0, reg0 = t_end, reg_end
    _, taps1, e1, _, _, _ = packed_edge_case("dense", True, "cpu")
    assert len(pc.launch_plan(taps1, e1)["groups"]) == 3   # 9 x 16 KiB
    _, taps1, e1, _, _, _ = packed_edge_case("ragged", True, "cpu")
    assert len(pc.launch_plan(taps1, e1)["groups"]) == 1


@pytest.fixture(scope="module")
def slab_model():
    """The 64-px yolov8n K=8 full-quant model of the port, its device plan
    on the CPU and its slab plan's ConvOps."""
    from alpha_yolo_quant_torch.engine_profile import build_model
    from alpha_yolo_quant_torch.runtime.interpreter import (
        device_plan, slab_plan,
    )

    model = build_model(64, "cpu")
    plan = device_plan(model, "cpu")
    sp = slab_plan(model, plan)
    ops = [op for v in sp.node_ops.values() for op in v
           if type(op).__name__ == "ConvOp"]
    assert len(ops) == sp.n_convs > 30
    return model, plan, sp, ops


def _conv_args(model, plan, sp, op, seed):
    """Random int8 input slabs in a ConvOp's geometry (B=2), resolved to
    the (slabs, taps) the kernel takes, and the op's entry."""
    from alpha_yolo_quant_torch.runtime.slabforward import SlabExec

    rng = np.random.default_rng(seed)
    ex = SlabExec(sp, model, plan, {}, model.cfg.qmax)
    for k, _, _ in op.taps:
        base = (k.split(":", 1)[1]
                if k.startswith(("s2e:", "s2o:", "eoe:", "eoo:")) else k)
        if base not in ex.slabs:
            ex.slabs[base] = torch.as_tensor(rng.integers(
                -127, 128, (2, sp.geoms[base].rows_ext, 128)),
                dtype=torch.int8)
    x_slabs, taps = ex.conv_inputs(op)
    return x_slabs, taps, ex.entry(op)


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "raw"])
def test_masked_product_equals_plain_on_slab_plan(slab_model, silu):
    """On every ConvOp of the 64-px slab plan, the kernel's masked product
    (only kept blocks, dead pieces as zeros) equals packed_call_plain and
    so the dense banded product, bit for bit."""
    model, plan, sp, ops = slab_model
    sig = plan["sig_lut"]
    skipped = dead = 0
    for i, op in enumerate(ops):
        x_slabs, taps, e = _conv_args(model, plan, sp, op, seed=i)
        e = dict(e, silu=silu)
        want = pc.packed_call_plain(x_slabs, taps, e, op.geom.gp2, op.h_out,
                                    sig, model.cfg.qmax)
        got = masked_call_np(x_slabs, taps, e, op.geom.gp2, op.h_out, sig,
                             model.cfg.qmax)
        np.testing.assert_array_equal(got, want.numpy(), err_msg=op.name)
        skipped += 32 * len(taps) - pc.kept_blocks(taps, e)
        dead += 8 - bin(e["live"]).count("1")
    assert skipped > 0 and dead > 0, "the plan must exercise both skips"


def test_masked_product_equals_oracle():
    """The masked emulation against the JAX package's numpy int64 oracle
    packed_conv_np on a 3x3 stride-1 conv (raw accumulators)."""
    cin = cout = 16
    hw = 32
    plan = pc.make_plan(cin, cout, 1, hw)
    x = RNG.integers(-127, 128, (2, cin, hw, hw)).astype(np.int64)
    mats = pc.packed_weight_mats(_weights(cin, cout, 3), plan)
    lanes = _lanes(plan, cout, False)
    gp2 = plan.g + 2
    taps = [(0, 3 * dy + gg, pc.FRONT_PAD + dy * gp2 + gg - 1)
            for dy in range(3) for gg in range(3)]
    e = pc.packed_entry(list(mats.reshape(9, 128, 128)), *lanes, False,
                        "cpu")
    assert pc.kept_blocks(taps, e) < 32 * 9
    out = masked_call_np([pc.pack_tensor(_nhwc(x), plan)], taps, e, gp2, hw,
                         None)
    _assert_equals_oracle(torch.as_tensor(out), x, mats, plan, hw, lanes[0])


@pytest.mark.parametrize("kind,silu", PACKED_EDGES,
                         ids=[k for k, _ in PACKED_EDGES])
def test_masked_product_equals_plain_on_edges(kind, silu):
    """The GPU tests' edge cases (dense, an all-zero tap, dead pieces,
    m under one tile, 32 taps over 8 slabs, accumulator extremes) through
    the masked emulation and the plain version on the CPU."""
    x_slabs, taps, e, gp2, h_out, sig = packed_edge_case(kind, silu, "cpu")
    want = pc.packed_call(x_slabs, taps, e, gp2, h_out, sig)
    got = masked_call_np(x_slabs, taps, e, gp2, h_out, sig)
    np.testing.assert_array_equal(got, want.numpy())


def _blocks_brute(w):
    """{(kc, nc)} of the k32 x n16 blocks of w with a nonzero, by loops."""
    return {(kc, nc) for kc in range(4) for nc in range(8)
            if any(w[k, n] for k in range(32 * kc, 32 * kc + 32)
                   for n in range(16 * nc, 16 * nc + 16))}


def test_block_masks_keep_exactly_the_nonzero_blocks(slab_model):
    """A mask bit is set iff its block holds a nonzero: over every tap
    matrix of the 64-px slab plan, and matrices with one nonzero at each
    block's corners, none at all, and none zero."""
    _, _, _, ops = slab_model
    one = []
    for kc, nc, dk, dn in [(0, 0, 0, 0), (3, 7, 31, 15), (1, 5, 31, 0),
                           (2, 2, 0, 15)]:
        w = np.zeros((128, 128), np.int8)
        w[32 * kc + dk, 16 * nc + dn] = -1
        one.append(w)
    mats = [w for op in ops for w in op.wlist] + one + [
        np.zeros((128, 128), np.int8), np.ones((128, 128), np.int8)]
    masks = pc.block_masks(mats)
    for w, mask in zip(mats, masks):
        got = {(b // 8, b % 8) for b in range(32) if mask >> b & 1}
        assert got == _blocks_brute(np.asarray(w))
    assert masks[-2:] == (0, 2 ** 32 - 1)
    assert masks[-6] == 1 and masks[-5] == 1 << 31


def test_live_pieces_need_a_column_or_a_bias():
    """A piece is dead only if it has zero columns in every matrix AND
    zero bias: the dead edge case keeps its bias-only piece 6 live."""
    _, _, e, _, _, _ = packed_edge_case("dead", True, "cpu")
    assert e["live"] == 0b11001101
    w = np.zeros((128, 128), np.int8)
    w[5, 40] = 1
    bias = np.zeros(128, np.int64)
    bias[127] = -3
    assert pc.live_pieces([w, np.zeros_like(w)], bias) == 0b10000100
    assert pc.live_pieces([np.zeros_like(w)], np.zeros(128)) == 0


def test_dead_pieces_map_to_zero(slab_model):
    """The ground for skipping dead pieces: on every ConvOp of the 64-px
    plan, a dead piece has zero bias and zero columns in every tap matrix,
    and the SiLU epilogue with the plan's lane constants maps acc 0 to 0
    on every lane (the raw epilogue trivially)."""
    model, plan, sp, ops = slab_model
    n_dead = 0
    for op in ops:
        ln = sp.lanes[op.name]
        e = pc.packed_entry(op.wlist, ln["bias"], ln["r1"], ln["s1"],
                            ln["r2"], ln["s2"], True, "cpu")
        zero = pc.fused_ops.silu_epilogue_plain(
            torch.zeros((1, 128), dtype=torch.int64), e, plan["sig_lut"],
            model.cfg.qmax)
        assert not zero.any(), op.name
        w = np.stack(op.wlist).reshape(len(op.wlist), 128, 8, 16)
        for nc in range(8):
            if not e["live"] >> nc & 1:
                n_dead += 1
                assert not w[:, :, nc].any()
                assert not np.asarray(ln["bias"]).reshape(8, 16)[nc].any()
    assert n_dead > 0


def _allow(name):
    return {"all": None,
            "h>=32": lambda n, c, h, w: h >= 32,
            "16..32": lambda n, c, h, w: 16 <= h <= 32}[name]


@pytest.mark.parametrize("allow", ["all", "h>=32", "16..32"])
def test_slab_plan_equals_jax(allow):
    """The same ops, taps, tap-matrix bytes, lanes and geometries."""
    tmodel, jmodel = build_pair(k=8, full_quant=True, seed=2)
    tp = build_slab_plan(tmodel, allow=_allow(allow))
    jp = j_build_slab_plan(jmodel, allow=_allow(allow))
    assert 0 < tp.n_convs == jp.n_convs
    assert_same(tp, jp, f"slab plan {allow}")
