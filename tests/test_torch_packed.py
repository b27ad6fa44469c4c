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
    wl = [RNG.integers(-127, 128, (128, 128)).astype(np.int8)
          for _ in range(2)]
    words = pc.packed_weights(wl)
    assert words.shape == (2, 32, 128) and words.dtype == np.int32
    back = words[..., None].view(np.int8)            # (2, 32, 128, 4)
    np.testing.assert_array_equal(back.transpose(0, 1, 3, 2).reshape(
        2, 128, 128), np.stack(wl))


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
