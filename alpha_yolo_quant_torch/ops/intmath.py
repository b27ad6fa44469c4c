"""Requantization in int64 (counterpart of
alpha_yolo_quant_tpu/ops/intmath.py).

The reference contract (quantize/primitives.requantize_np) is
``clip(rhu((m * x) >> (shift - 1)), -qmax, qmax)`` with
``rhu(q) = (q >> 1) + (q & 1)`` and arithmetic (floor) shifts. Torch and
CUDA have native int64, so this is the formula itself: the TPU's widening
emulation and its proven int32 variants are not needed (the tests show
the variants all equal this form).
"""

from __future__ import annotations

import torch


def _as_i64(v, device) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.int64, device=device)


def round_half_up(q: torch.Tensor) -> torch.Tensor:
    """q//2 + q%2 with floor semantics: round half toward +inf."""
    return (q >> 1) + (q & 1)


def requantize(x: torch.Tensor, m, shift, qmax: int) -> torch.Tensor:
    """Exact requantization in int64; ``m`` and ``shift`` broadcast against
    ``x`` (``m`` may fold a sigmoid LUT value into the rescale). Returns
    int64."""
    x64 = x.to(torch.int64)
    q = (_as_i64(m, x.device) * x64) >> (_as_i64(shift, x.device) - 1)
    return torch.clamp(round_half_up(q), -qmax, qmax)


def requantize_small(x: torch.Tensor, m: int, shift: int,
                     qmax: int) -> torch.Tensor:
    """Scalar requant of a small tensor (residual/concat inputs,
    |x| <= 2*qmax, m < 2^8): |m*x| < 2^31, so int32 is exact. Returns
    int32."""
    q = (int(m) * x.to(torch.int32)) >> (int(shift) - 1)
    return torch.clamp(round_half_up(q), -qmax, qmax)
