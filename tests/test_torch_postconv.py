"""The port's ``pallas``-engine pieces against the JAX package: the nibble
split conv2d_int_parts against JAX's (XLA), and the postconv epilogues
(the plain versions of the K3/K4 kernels, as they run on the CPU) against
JAX fused_postconv_silu / fused_postconv_plain in Pallas interpret mode.
Bit-exact (tolerance 0)."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

from alpha_yolo_quant_tpu.ops.nn import conv2d_int_parts as j_parts
from alpha_yolo_quant_tpu.quantize.luts import sigmoid_lut as j_sigmoid_lut
from alpha_yolo_quant_torch.ops.lut import DeviceLut
from alpha_yolo_quant_torch.ops.nn import conv2d_int_parts
from alpha_yolo_quant_torch.quantize.luts import sigmoid_lut
from alpha_yolo_quant_torch.runtime import fused_ops

RNG = np.random.default_rng(77)
SIG = DeviceLut(sigmoid_lut(6.0, 8), "cpu")


@pytest.fixture(scope="module")
def jax_corrections():
    from alpha_yolo_quant_tpu.runtime.pallas_ops import (
        pallas_sigma_corrections,
    )

    return pallas_sigma_corrections(j_sigmoid_lut(6.0, 8))


def _case(wide: bool, kernel: int, stride: int, cin=12, cout=16, hw=8):
    """NHWC input (int16 up to 3*qmax when wide), weights and requant
    constants sized so the SiLU outputs spread over the int8 range."""
    amax = 381 if wide else 127
    x = RNG.integers(-amax, amax + 1, (2, hw, hw, cin))
    w = RNG.integers(-127, 128, (cout, cin, kernel, kernel))
    b = RNG.integers(-2 ** 15, 2 ** 15, cout)
    rms = float(np.sqrt(cin * kernel * kernel) * amax * 73)
    r1, r2 = RNG.integers(64, 256, cout), RNG.integers(64, 256, cout)
    s1 = np.ceil(np.log2(r1 * rms / 48.0)).astype(np.int64) + 1
    s2 = np.ceil(np.log2(r2 * 64 * rms / 48.0)).astype(np.int64) + 1
    c = fused_ops.conv_entry(w, b, stride, kernel // 2, True, "cpu", r1=r1,
                             s1=s1, r2=r2, s2=s2)
    xt = torch.as_tensor(x, dtype=torch.int16 if wide else torch.int8)
    return x, w, xt, c


@pytest.mark.parametrize("kernel,stride,wide", [(3, 1, False), (3, 2, True),
                                                (1, 1, True)])
def test_conv2d_int_parts_equals_jax(kernel, stride, wide):
    x, w, xt, c = _case(wide, kernel, stride)
    hi, lo = conv2d_int_parts(xt, c)
    jhi, jlo = j_parts(jnp.asarray(x, jnp.int32),
                       jnp.asarray(w.transpose(2, 3, 1, 0), jnp.int32),
                       stride, kernel // 2, nhwc=True)
    assert hi.dtype == lo.dtype == torch.float32
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    if wide:
        assert float(hi.abs().max()) > 127 * 16, "wide parts must be wide"


@pytest.mark.parametrize("silu", [True, False], ids=["silu", "plain"])
@pytest.mark.parametrize("wide", [False, True], ids=["int8", "wide"])
def test_postconv_equals_jax_pallas_kernel(silu, wide, jax_corrections):
    """NCHW as the JAX signature takes it; the NHWC view (channel axis 3,
    what the port's engine passes) gives the same values; and the whole
    thing equals the fused conv's plain version."""
    from alpha_yolo_quant_tpu.runtime.pallas_ops import (
        fused_postconv_plain, fused_postconv_silu,
    )

    _, _, xt, c = _case(wide, 3, 1)
    hi, lo = conv2d_int_parts(xt, c)          # NHWC float32
    hi_c = hi.permute(0, 3, 1, 2).contiguous()
    lo_c = lo.permute(0, 3, 1, 2).contiguous()
    consts = [c[f] for f in ("b", "r1", "s1", "r2", "s2")]
    jc = [jnp.asarray(t.numpy()) for t in consts]
    if silu:
        got = fused_ops.postconv_silu(hi_c, lo_c, *consts, SIG)
        got_nhwc = fused_ops.postconv_silu(hi, lo, *consts, SIG, axis=3)
        want = fused_postconv_silu(
            jnp.asarray(hi_c.numpy()), jnp.asarray(lo_c.numpy()), *jc,
            qmax=127, sig_scale=float(127 / SIG.lut.max_val),
            sig_qmax=127.0, corrections=jax_corrections)
        assert got.dtype == torch.int8
        assert len(np.unique(got.numpy())) > 20, "constants must spread"
    else:
        got = fused_ops.postconv_plain(hi_c, lo_c, consts[0])
        got_nhwc = fused_ops.postconv_plain(hi, lo, consts[0], axis=3)
        want = fused_postconv_plain(jnp.asarray(hi_c.numpy()),
                                    jnp.asarray(lo_c.numpy()), jc[0])
        assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got_nhwc, got.permute(0, 2, 3, 1))
    whole = fused_ops.conv_plain(xt, dict(c, silu=silu), SIG, 127)
    assert torch.equal(got_nhwc, whole)


def test_postconv_rejects_bad_axis_and_device():
    hi = torch.zeros((1, 4, 2, 2))
    b = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError):
        fused_ops.postconv_plain(hi.to("meta"), hi.to("meta"), b.to("meta"))
    got = fused_ops.postconv_plain(hi, hi, b, axis=1)
    assert got.shape == hi.shape and got.dtype == torch.int32
