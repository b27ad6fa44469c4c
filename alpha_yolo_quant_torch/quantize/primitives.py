"""Bit-exact host-side quantization primitives (numpy float64/int64).

These mirror the reference's L0 arithmetic contract exactly — including its
rounding idioms (numpy half-to-even for weights, *truncation* for biases,
round-half-toward-+inf for requantization) — and are used offline by the
quantizer/transform. The on-device runtime consumes only the integer
artifacts these produce (ops/intmath.py re-implements the requantization
step on int32 lanes).

Reference contract:
  scale law            quantisation/utils/scale.py:4-5, utils/a.py:4-5
  clip                 quantisation/utils/clip.py:1-4
  per-outch weights    quantisation/utils/quant_matrix.py:56-78
  truncating bias      quantisation/utils/quant_bias.py:2-4, utils/bias_scale.py:4-5
  requantization       quantisation/utils/rescale_coeff.py:29-55

The port's own copy of alpha_yolo_quant_tpu/quantize/primitives.py,
numpy logic unchanged.
"""

from __future__ import annotations

import numpy as np


class RescaleOverflowError(RuntimeError):
    """Raised when a rescale coefficient cannot fit the koeff-bit budget
    (the reference prints and exit()s: utils/rescale_coeff.py:40-42)."""


def scale_for(a, k: int):
    """Symmetric max-abs scale: (2^(K-1)-1)/a (reference utils/scale.py:4-5)."""
    return (2 ** (k - 1) - 1) / a


def amax(m) -> float:
    """Max-abs statistic (reference utils/a.py:4-5)."""
    return float(np.abs(m).max())


def clip_sym(m: np.ndarray, k: int) -> np.ndarray:
    """Clip to +-(2^(K-1)-1) (reference utils/clip.py:1-4)."""
    q = 2 ** (k - 1) - 1
    return np.clip(m, -q, q)


def quant_matrix(matrix: np.ndarray, k: int, start: bool = False):
    """Per-dim0-slice symmetric quantization (reference utils/quant_matrix.py:56-78).

    For conv weights dim 0 is the output channel -> per-output-channel weight
    scales. For the input image, ``start=True`` pins a=1 (the [0,1] image
    domain, reference utils/quant_matrix.py:70-72).

    Returns (int64 matrix, scales of shape (dim0, 1)).

    DTYPE-FOLLOWING on purpose: the reference quantizes the float32 state
    dict AS float32 — ``a`` is an f32 numpy scalar, ``(2^(K-1)-1)/a``
    stays f32 under NEP50, and the clip*scale product rounds in f32
    (utils/quant_matrix.py:66-77 over weights_activ's f32 arrays) — while
    float64 inputs flow through in f64. Promoting to f64 here flips
    rounding at ties and breaks byte parity of the whole export tree
    (caught by the stage-6 whole-tree diff). The returned scales array is
    f64 *storage* of those dtype-native values, like the reference's
    ``all_scales`` accumulator.
    """
    m = np.asarray(matrix)
    n = m.shape[0]
    scales = np.zeros((n, 1), np.float64)
    out = np.zeros(m.shape, np.int64)
    for i in range(n):
        # reference: a = abs(m).max() (dtype-native scalar) or the python
        # int 1 for start=True — int keeps the scale a weak python float
        # so the product stays in the input dtype
        a = 1 if start else np.abs(m[i]).max()
        s = (2 ** (k - 1) - 1) / a
        scales[i, 0] += s
        clipped = np.clip(m[i], -a, a)
        out[i] = np.int64(np.round(clipped * s))
    return out, scales


def quant_bias(bias: np.ndarray, bias_scale) -> np.ndarray:
    """Bias quantization with TRUNCATION toward zero — np.int64(b*s), not
    rounding (reference utils/quant_bias.py:2-4). bias_scale =
    weight_scale * activation_scale (reference utils/bias_scale.py:4-5)."""
    return np.int64(np.asarray(bias, np.float64) * bias_scale)


def derive_rescale_shift(old_scale, new_scale, koeff_bits: int = 8):
    """Derive the integer (rescale, shift) pair for old_scale -> new_scale.

    shift = koeff_bits + floor(log2(old/new)); rescale = round(2^shift*new/old),
    with one retry at shift-1 if any rescale exceeds 2^koeff_bits-1, else abort
    (reference utils/rescale_coeff.py:33-42). ``old_scale`` may be a per-channel
    array ((1,C,1,1)); the retry decrements the WHOLE shift array when any
    element overflows, exactly like the reference.

    Returns (rescale int64 array-or-scalar, shift float64 array-or-scalar).
    """
    old = np.asarray(old_scale, np.float64)
    new = float(new_scale)
    if not (np.all(old > 0) and new > 0):
        z = np.zeros_like(old)
        return np.int64(z), np.float64(z)
    limit = 2 ** koeff_bits - 1
    shift = koeff_bits + np.floor(np.log2(old / new))
    rescale = np.int64(np.round((2.0 ** shift) * (new / old)))
    if rescale.max() > limit:
        shift = shift - 1
        rescale = np.int64(np.round((2.0 ** shift) * (new / old)))
        if rescale.max() > limit:
            raise RescaleOverflowError(
                f"rescale {rescale.max()} > {limit} (old={old}, new={new})"
            )
    return rescale, shift


def requantize_np(arr: np.ndarray, old_scale, new_scale, k: int,
                  koeff_bits: int = 8):
    """Reference-exact requantization (reference utils/rescale_coeff.py:29-55).

    q = (rescale * x) // 2^(shift-1);  q = q//2 + q%2;  clip to +-(2^(K-1)-1).

    Note the reference divides an int64 product by a float64 power of two
    (shift comes from np.floor → float64); for the magnitudes in this pipeline
    (< 2^47) float64 floor-division is exact, so we keep pure int64 semantics.

    Returns (int64 array, rescale, shift) like the reference.
    """
    qmax = 2 ** (k - 1) - 1
    x = np.asarray(arr, np.int64)
    old = np.asarray(old_scale, np.float64)
    new = float(new_scale)
    if not (np.all(old > 0) and new > 0):
        z = np.zeros_like(x)
        return z, 0, np.int64(0)
    rescale, shift = derive_rescale_shift(old, new, koeff_bits)
    shift_i = np.int64(shift)
    q = (np.int64(rescale) * x) >> np.maximum(shift_i - 1, 0)
    # shift==0 would mean no pre-round division; the pipeline never produces
    # it (assert, rather than silently diverging from the reference).
    if np.any(shift_i < 1):
        raise RescaleOverflowError(f"shift < 1: {shift_i}")
    q = (q >> 1) + (q & 1)
    q = np.clip(q, -qmax, qmax)
    return np.int64(q), rescale, shift_i
