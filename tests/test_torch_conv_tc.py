"""Host side of the tensor-core conv kernels (runtime/csrc/conv_igemm.cuh):
the packed weight layout, the checks the wrappers make before a launch,
and the split of wide int16 inputs into int8 tensor-core operands held
against the JAX package's conv2d_s8_exact. Bit-exact (tolerance 0)."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

from alpha_yolo_quant_tpu.ops.nn import conv2d_s8_exact
from alpha_yolo_quant_torch.ops.lut import DeviceLut
from alpha_yolo_quant_torch.ops.nn import conv2d_int_exact
from alpha_yolo_quant_torch.quantize.luts import sigmoid_lut
from alpha_yolo_quant_torch.runtime import fused_ops

RNG = np.random.default_rng(44)
SIG = DeviceLut(sigmoid_lut(6.0, 8), "cpu")


@pytest.mark.parametrize("cin,cout,k", [(3, 16, 3), (6, 20, 3), (16, 16, 3),
                                        (48, 32, 1), (64, 80, 1),
                                        (80, 72, 3), (256, 256, 3)])
def test_pack_weights_round_trips_to_oihw(cin, cout, k):
    """(Cout, Kp) int8, row n = channel n at depth (dy*k + dx)*Cin + c,
    zero from K = k*k*Cin to Kp, the next multiple of K_TILE."""
    w = RNG.integers(-127, 128, (cout, cin, k, k))
    p = fused_ops.pack_weights(w)
    depth = k * k * cin
    kp = fused_ops.packed_depth(depth)
    assert kp % fused_ops.K_TILE == 0 and depth <= kp < depth + 64
    assert p.dtype == np.int8 and p.shape == (cout, kp)
    assert p.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(p[:, depth:], 0)
    np.testing.assert_array_equal(
        p[:, :depth].reshape(cout, k, k, cin).transpose(0, 3, 1, 2), w)


def _entry(cin=16, cout=24, k=3, silu=False):
    w = RNG.integers(-127, 128, (cout, cin, k, k))
    r = np.full(cout, 100)
    return fused_ops.conv_entry(w, np.zeros(cout), 1, k // 2, silu, "cpu",
                                r1=r, s1=r // 10, r2=r, s2=r // 5)


def _misaligned(shape, dtype=torch.int8):
    """A contiguous tensor whose data starts one element past a 16-byte
    boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


def _old_layout(c):
    """The earlier __dp4a kernels' weights: int32 words (Kp/4, Cout)."""
    kp = fused_ops.packed_depth(c["kernel"] ** 2 * c["cin"])
    return dict(c, w_packed=torch.zeros((kp // 4, c["cout"]),
                                        dtype=torch.int32))


BAD_INPUTS = {
    "int32 activations": (lambda: torch.zeros((1, 5, 5, 16), dtype=torch.int32),
                          _entry),
    "not NHWC 4-d": (lambda: torch.zeros((5, 5, 16), dtype=torch.int8),
                     _entry),
    "not contiguous": (lambda: torch.zeros((1, 16, 5, 5), dtype=torch.int8)
                       .permute(0, 2, 3, 1), _entry),
    "channel count": (lambda: torch.zeros((1, 5, 5, 32), dtype=torch.int8),
                      _entry),
    "int8 input off 16 bytes": (lambda: _misaligned((1, 5, 5, 16)), _entry),
    "int16 input off 16 bytes": (
        lambda: _misaligned((1, 5, 5, 16), torch.int16), _entry),
    "old int32 weight words": (lambda: torch.zeros((1, 5, 5, 16),
                                                   dtype=torch.int8),
                               lambda: _old_layout(_entry())),
    "weights off 16 bytes": (
        lambda: torch.zeros((1, 5, 5, 16), dtype=torch.int8),
        lambda: dict(_entry(), w_packed=_misaligned((24, 192)))),
    "weights of another depth": (
        lambda: torch.zeros((1, 5, 5, 16), dtype=torch.int8),
        lambda: dict(_entry(), w_packed=torch.zeros((24, 128),
                                                    dtype=torch.int8))),
    "weights on another device": (
        lambda: torch.zeros((1, 5, 5, 16), dtype=torch.int8),
        lambda: dict(_entry(), w_packed=torch.zeros(
            (24, 192), dtype=torch.int8, device="meta"))),
}


@pytest.mark.parametrize("case", sorted(BAD_INPUTS))
def test_check_conv_raises_on_what_the_kernel_cannot_take(case):
    make_x, make_c = BAD_INPUTS[case]
    with pytest.raises((TypeError, ValueError)):
        fused_ops._check_conv("conv3x3", make_x(), make_c(), SIG, 127)


def test_check_conv_takes_the_gathered_and_aligned_inputs():
    """Cin % 16 != 0 takes the gathered loader, which needs no alignment;
    Cin % 16 == 0 from a fresh allocation is 16-byte aligned."""
    fused_ops._check_conv("conv3x3", _misaligned((1, 5, 5, 6)),
                          _entry(cin=6), SIG, 127)
    fused_ops._check_conv("conv3x3", torch.zeros((1, 5, 5, 16),
                                                 dtype=torch.int16),
                          _entry(silu=True), SIG, 127)


def test_conv1x1_refuses_stride_and_padding():
    x = torch.zeros((1, 6, 6, 16), dtype=torch.int8)
    for stride, pad in ((2, 0), (1, 1)):
        c = dict(_entry(k=1), stride=stride, padding=pad)
        with pytest.raises(ValueError):
            fused_ops.conv1x1(x, c)


def _byte_split_acc(x: torch.Tensor, c) -> torch.Tensor:
    """The kernel's wide path in int64, wrapped to int32 as the s32 MMA
    accumulator wraps: pass 1 over the high bytes (x >> 8, s8), the sum
    times 256, pass 2 over the low bytes (x & 255, u8), then the bias."""
    def conv(t):
        return conv2d_int_exact(t.permute(0, 3, 1, 2), c["w_f64"],
                                c["stride"], c["padding"]).to(torch.int64)

    hi, lo = (x.to(torch.int64) >> 8), (x.to(torch.int64) & 255)
    assert int(hi.min()) >= -128 and int(hi.max()) <= 127
    acc = (conv(hi) * 256 + conv(lo)).permute(0, 2, 3, 1) + c["b"]
    return ((acc + 2 ** 31) % 2 ** 32) - 2 ** 31


@pytest.mark.parametrize("k,stride", [(1, 1), (3, 1), (3, 2)])
def test_wide_split_equals_jax_conv2d_s8_exact(k, stride):
    """At |x| <= 381 (3*qmax, the widest edge a K=8 model stores) the JAX
    package's three-part clip split, the kernel's byte split and the
    port's plain conv give one accumulator."""
    cin, cout = 32, 24
    x = RNG.integers(-381, 382, (2, 9, 9, cin))
    x[0, 0, 0, :] = 381
    x[0, 0, 1, :] = -381
    w = RNG.integers(-127, 128, (cout, cin, k, k))
    c = fused_ops.conv_entry(w, np.zeros(cout), stride, k // 2, False, "cpu")
    xt = torch.as_tensor(x, dtype=torch.int16)
    want = fused_ops.conv_acc_plain(xt, c)
    jax_acc = conv2d_s8_exact(
        jnp.asarray(x, jnp.int16), jnp.asarray(w.transpose(2, 3, 1, 0),
                                               jnp.int8),
        stride=stride, padding=k // 2, parts=3, nhwc=True)
    np.testing.assert_array_equal(np.asarray(jax_acc), want.numpy())
    assert torch.equal(_byte_split_acc(xt, c), want)


def test_byte_split_is_exact_over_the_int16_range():
    """The byte split holds for every int16, not only the +-381 the
    quantizer stores: the accumulator is exact while the true sum fits
    int32, and the bias is added after the wrap."""
    cin, cout = 16, 8
    x = RNG.integers(-2 ** 15, 2 ** 15, (1, 6, 6, cin))
    x[0, 0, 0, :4] = [-2 ** 15, 2 ** 15 - 1, -1, 255]
    w = RNG.integers(-127, 128, (cout, cin, 3, 3)) // 8
    c = fused_ops.conv_entry(w, RNG.integers(-2 ** 15, 2 ** 15, cout), 1, 1,
                             False, "cpu")
    xt = torch.as_tensor(x, dtype=torch.int16)
    want = fused_ops.conv_acc_plain(xt, c)
    assert int(want.abs().max()) < 2 ** 31
    assert torch.equal(_byte_split_acc(xt, c), want)
