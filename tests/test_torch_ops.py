"""The PyTorch port's integer ops and kernel plain versions against the JAX
package (its Pallas kernels in interpret mode) and the numpy oracles.
Bit-exact (tolerance 0) throughout."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

from alpha_yolo_quant_tpu.ops import intmath as jim
from alpha_yolo_quant_tpu.quantize.luts import exponent_lut, sigmoid_lut
from alpha_yolo_quant_tpu.quantize.primitives import (
    derive_rescale_shift, requantize_np,
)
from alpha_yolo_quant_tpu.runtime.golden import conv2d_int64, maxpool_int64
from alpha_yolo_quant_torch.ops.intmath import requantize, requantize_small
from alpha_yolo_quant_torch.ops.lut import DeviceLut
from alpha_yolo_quant_torch.ops.nn import (
    conv2d_int_exact, maxpool2d, upsample_nearest,
)
from alpha_yolo_quant_torch.runtime import fused_ops

RNG = np.random.default_rng(2024)


def _rq_np(x, m, s, qmax):
    q = (np.int64(m) * np.int64(x)) >> (np.int64(s) - 1)
    return np.clip((q >> 1) + (q & 1), -qmax, qmax)


def _t(a):
    return torch.as_tensor(np.array(a))


def _draw(variant, n=20000):
    """(x, m, shift) on each JAX int32 variant's preconditioned range."""
    if variant == "i32":          # int32 x, m < 2^15, (m*x) >> (s-1) in int32
        x = RNG.integers(-(2 ** 31), 2 ** 31, n)
        m = RNG.integers(0, 1 << 15, n)
        s = RNG.integers(1, 48, n)
        ok = np.abs((m * x) >> (s - 1)) < 2 ** 30
        x, m, s = x[ok], m[ok], s[ok]
    elif variant == "bigshift":   # shift >= 16
        x = RNG.integers(-(2 ** 31), 2 ** 31, n)
        m = RNG.integers(0, 1 << 15, n)
        s = RNG.integers(16, 48, n)
    elif variant == "folded":     # + floor(m|x|/2^15) + 1 + 2^(s-16) < 2^31
        x = RNG.integers(-(2 ** 24), 2 ** 24, n)
        m = RNG.integers(0, 1 << 15, n)
        s = RNG.integers(16, 40, n)
    elif variant == "direct":     # m|x| + 2^(s-1) < 2^31
        x = RNG.integers(-(2 ** 22), 2 ** 22, n)
        m = RNG.integers(0, 256, n)
        s = RNG.integers(1, 30, n)
    else:                         # small: |m*x| < 2^31, scalar m, shift
        x = RNG.integers(-510, 511, n)
        m = np.int64(RNG.integers(1, 256))
        s = np.int64(RNG.integers(1, 20))
    return x, m, s


JAX_VARIANTS = {
    "i32": jim.requantize_i32, "bigshift": jim.requantize_i32_bigshift,
    "folded": jim.requantize_i32_bigshift_folded,
    "direct": jim.requantize_i32_direct, "small": jim.requantize_i32_small,
}


@pytest.mark.parametrize("variant", sorted(JAX_VARIANTS))
@pytest.mark.parametrize("qmax", [127, 2 ** 15 - 1])
def test_requantize_equals_jax_int32_variants_and_int64(variant, qmax):
    x, m, s = _draw(variant)
    want = _rq_np(x, m, s, qmax)
    got = requantize(_t(x), _t(m), _t(s), qmax).numpy()
    np.testing.assert_array_equal(got, want)
    jx = np.asarray(JAX_VARIANTS[variant](
        jnp.asarray(x, jnp.int32), jnp.asarray(m, jnp.int32),
        jnp.asarray(s, jnp.int32), qmax))
    np.testing.assert_array_equal(jx, want)
    if variant == "small":
        np.testing.assert_array_equal(
            requantize_small(_t(x).to(torch.int16), int(m), int(s),
                             qmax).numpy(), want)


def test_requantize_floor_shift_on_negatives_and_shift_one():
    """>> floors negative int64 (not truncation), and shift-1 = 0 is the
    identity pre-round."""
    x = torch.tensor([-7, -8, -1, 5, 3], dtype=torch.int64)
    np.testing.assert_array_equal((x >> 1).numpy(), [-4, -4, -1, 2, 1])
    got = requantize(x, 1, 1, 127).numpy()     # rhu(x) = ceil(x / 2)
    np.testing.assert_array_equal(got, [-3, -4, 0, 3, 2])
    np.testing.assert_array_equal(got, _rq_np(x.numpy(), 1, 1, 127))


def test_requantize_equals_requantize_np_from_scales():
    for k in (2, 4, 6, 8):
        qmax = 2 ** (k - 1) - 1
        old = np.exp(RNG.uniform(np.log(2.0), np.log(5e4), (1, 6, 1, 1)))
        new = float(np.exp(RNG.uniform(np.log(0.5), np.log(50.0))))
        x = RNG.integers(-(2 ** 24), 2 ** 24, (3, 6, 5, 5))
        want, r, s = requantize_np(x, old, new, k)
        r2, s2 = derive_rescale_shift(old, new)
        np.testing.assert_array_equal(r, r2)
        got = requantize(_t(x), _t(np.int64(r)), _t(np.int64(s)), qmax)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("stride,pad,wide", [(1, 1, False), (2, 1, False),
                                             (1, 0, True), (2, 1, True)])
def test_conv2d_int_exact_equals_golden(stride, pad, wide):
    amax = 381 if wide else 127
    x = RNG.integers(-amax, amax + 1, (2, 5, 9, 9))
    k = 1 if pad == 0 else 3
    w = RNG.integers(-127, 128, (7, 5, k, k))
    want = conv2d_int64(x, w, stride, pad)
    got = conv2d_int_exact(_t(x).to(torch.int16), _t(w), stride, pad)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("nhwc", [False, True])
def test_maxpool_and_upsample_equal_golden(nhwc):
    x = RNG.integers(-381, 382, (2, 3, 7, 6))
    want_pool = maxpool_int64(x, 5, 1, 2)
    want_up = np.repeat(np.repeat(x, 2, axis=2), 2, axis=3)
    xt = _t(x).to(torch.int16)
    if nhwc:
        xt = xt.permute(0, 2, 3, 1).contiguous()
    pool = maxpool2d(xt, 5, 1, 2, nhwc=nhwc)
    up = upsample_nearest(xt, 2, nhwc=nhwc)
    if nhwc:
        pool, up = pool.permute(0, 3, 1, 2), up.permute(0, 3, 1, 2)
    assert pool.dtype == torch.int16
    np.testing.assert_array_equal(pool.numpy(), want_pool)
    np.testing.assert_array_equal(up.numpy(), want_up)


@pytest.mark.parametrize("lut", [sigmoid_lut(6.0, 8), sigmoid_lut(7.0, 4),
                                 sigmoid_lut(12.0, 16),
                                 exponent_lut(14.8264799118042, 8)],
                         ids=["sig8", "sig4", "sig16", "exp8"])
def test_lut_table_read_equals_apply_np(lut):
    x = np.arange(lut.lo - 40, lut.hi + 41)
    d = DeviceLut(lut, "cpu")
    np.testing.assert_array_equal(d.apply(_t(x)).numpy(), lut.apply_np(x))
    inside = np.arange(lut.lo, lut.hi + 1)
    np.testing.assert_array_equal(d.apply_clipped(_t(inside)).numpy(),
                                  lut.apply_np(inside))


def test_pack_weights_layout():
    w = RNG.integers(-127, 128, (5, 3, 3, 3))
    p = fused_ops.pack_weights(w)
    assert p.shape == (32 // 4, 5) and p.dtype == np.int32
    back = p.T.copy().view(np.int8).reshape(5, -1)
    np.testing.assert_array_equal(back[:, 27:], 0)
    np.testing.assert_array_equal(
        back[:, :27].reshape(5, 3, 3, 3).transpose(0, 3, 1, 2), w)


# -- the kernels' plain versions against the JAX Pallas kernels (interpret
# mode on CPU: each call recompiles, so these stay few and small) ----------

SIG = sigmoid_lut(6.0, 8)


@pytest.fixture(scope="module")
def jax_corrections():
    from alpha_yolo_quant_tpu.runtime.pallas_ops import (
        pallas_sigma_corrections,
    )

    return pallas_sigma_corrections(SIG)


def test_sigma_corrections_equal_jax_probe(jax_corrections):
    """Both probes return fixups against Lut.values: the JAX kernel's
    arithmetic sigmoid needs a few, each one a table entry; the port's
    table read needs none, and its probe returns the table itself."""
    d = DeviceLut(SIG, "cpu")
    assert fused_ops.sigma_corrections(d) == ()
    np.testing.assert_array_equal(fused_ops.sigma_probe(d).numpy(),
                                  SIG.values)
    assert len(jax_corrections) < 16
    for i, v in jax_corrections:
        assert SIG.values[i - SIG.lo] == v


@pytest.mark.parametrize("case", ["1x1_silu", "1x1_plain", "3x3_s1",
                                  "3x3_s2"])
def test_conv_plain_equals_jax_fused_kernel(case, jax_corrections):
    from alpha_yolo_quant_tpu.runtime.pallas_ops import (
        fused_conv1x1, fused_conv3x3,
    )

    cin, cout, hw = 16, 32, 8
    kern = 1 if case.startswith("1x1") else 3
    stride = 2 if case == "3x3_s2" else 1
    silu = case != "1x1_plain"
    w = RNG.integers(-127, 128, (cout, cin, kern, kern))
    b = RNG.integers(-2 ** 15, 2 ** 15, cout)
    x = RNG.integers(-127, 128, (1, hw, hw, cin))
    r1 = RNG.integers(64, 256, cout)
    r2 = RNG.integers(64, 256, cout)
    s1 = RNG.integers(18, 24, cout)
    s2 = RNG.integers(24, 30, cout)
    c = fused_ops.conv_entry(w, b, stride, kern // 2, silu, "cpu", r1=r1,
                             s1=s1, r2=r2, s2=s2)
    sig = DeviceLut(SIG, "cpu")
    wrapper = fused_ops.conv1x1 if kern == 1 else fused_ops.conv3x3
    got = wrapper(_t(x).to(torch.int8), c, sig, 127).numpy()

    i32 = [jnp.asarray(v, jnp.int32) for v in (b, r1, s1, r2, s2)]
    kw = dict(qmax=127, sig_scale=float(127 / SIG.max_val), sig_qmax=127.0,
              corrections=jax_corrections, silu=silu)
    if kern == 1:
        want = fused_conv1x1(jnp.asarray(x, jnp.int8),
                             jnp.asarray(w[:, :, 0, 0].T, jnp.int8),
                             *i32, **kw)
    else:
        w_tap = w.transpose(1, 2, 3, 0).reshape(-1, cout)
        want = fused_conv3x3(jnp.asarray(x, jnp.int8),
                             jnp.asarray(w_tap, jnp.int8), *i32,
                             stride=stride, **kw)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if silu:
        assert len(np.unique(got)) > 20, "constants must not saturate"
    np.testing.assert_array_equal(got, want)


def test_wrappers_reject_non_cpu_non_cuda_and_bad_geometry():
    w = RNG.integers(-3, 4, (4, 4, 3, 3))
    c = fused_ops.conv_entry(w, np.zeros(4), 1, 1, False, "cpu")
    with pytest.raises(ValueError):
        fused_ops.conv1x1(torch.zeros((1, 4, 4, 4), dtype=torch.int8), c)
    x = torch.zeros((1, 4, 4, 4), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        fused_ops.conv3x3(x, c)
