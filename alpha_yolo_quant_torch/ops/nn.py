"""NN helpers: the float path and the plain exact integer conv
(counterpart of alpha_yolo_quant_tpu/ops/nn.py).

Public functions take NCHW/OIHW like the JAX ones; ``nhwc=True`` selects
the layout the integer runtime keeps its activations in (the nibble split
conv2d_int_parts takes NHWC only: it serves that runtime).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_f32(x, w, b=None, stride: int = 1, padding: int = 0):
    """Float conv (cross-correlation), NCHW/OIHW."""
    return F.conv2d(x, w, b, stride=stride, padding=padding)


def silu(x):
    return x * torch.sigmoid(x)


def maxpool2d(x, kernel: int = 5, stride: int = 1, padding: int = 2,
              nhwc: bool = False):
    """Max-pool with the window clipped to the valid region: padding never
    wins (F.max_pool2d pads with -inf). Integer inputs go through float32,
    which holds every int16 value exactly."""
    if nhwc:
        x = x.permute(0, 3, 1, 2)
    out = F.max_pool2d(x.to(torch.float32), kernel, stride, padding)
    out = out.to(x.dtype)
    return out.permute(0, 2, 3, 1).contiguous() if nhwc else out


def upsample_nearest(x, factor: int = 2, nhwc: bool = False):
    """Nearest upsample: repeat every pixel factor x factor times."""
    if nhwc:
        b, h, w, c = x.shape
        return (x[:, :, None, :, None, :]
                .expand(b, h, factor, w, factor, c)
                .reshape(b, h * factor, w * factor, c))
    b, c, h, w = x.shape
    return (x[:, :, :, None, :, None]
            .expand(b, c, h, factor, w, factor)
            .reshape(b, c, h * factor, w * factor))


def conv2d_int_exact(x_int, w, stride: int = 1, padding: int = 0):
    """Exact integer conv, NCHW/OIHW -> int64, on any device.

    Runs F.conv2d in float64: every product and every partial sum is an
    integer below 2^31 (bound checked per conv by
    quantize/transform._check_accumulator_bounds), far inside float64's
    2^53 exact-integer range, so any summation order gives the exact
    result. Never run it on int8 tensors: an int8 conv2d wraps."""
    acc = F.conv2d(x_int.to(torch.float64), w.to(torch.float64),
                   stride=stride, padding=padding)
    return acc.to(torch.int64)


def conv2d_int_parts(x_nhwc: torch.Tensor, c: dict):
    """The two nibble-split partial convs of the ``pallas`` engine
    (alpha_yolo_quant_tpu/ops/nn.py conv2d_int_parts): x = 16*(x >> 4) +
    (x & 15), each part conv'd alone, so acc = 16*hi + lo + bias.

    x_nhwc: int8 or wide int16 NHWC; c: the conv's plan entry
    (runtime/fused_ops.conv_entry). ``x >> 4`` is an arithmetic shift, in
    [-24, 23] for |x| <= 381, and ``x & 15`` is in [0, 15], so both parts
    are int8 and run on the conv kernels (the plain epilogue, zero bias:
    exact int32). Returns (hi, lo) as float32 NHWC, the form the postconv
    kernels read; every partial sum is an integer below 2^24
    (quantize/transform._check_accumulator_bounds), so float32 holds it
    exactly."""
    from alpha_yolo_quant_torch.runtime import fused_ops

    conv = fused_ops.conv1x1 if c["kernel"] == 1 else fused_ops.conv3x3
    parts = dict(c, silu=False, b=torch.zeros_like(c["b"]))
    x_hi = (x_nhwc >> 4).to(torch.int8).contiguous()
    x_lo = (x_nhwc & 15).to(torch.int8).contiguous()
    return (conv(x_hi, parts).to(torch.float32),
            conv(x_lo, parts).to(torch.float32))
