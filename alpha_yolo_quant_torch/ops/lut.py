"""LUT application as a table read (counterpart of
alpha_yolo_quant_tpu/ops/lutfast.py).

The TPU recomputed each table arithmetically with per-backend fixups
because gathers were slow there; here ``Lut.values`` is read directly, so
the result is the table by construction on every device.
"""

from __future__ import annotations

import torch

from alpha_yolo_quant_torch.quantize.luts import Lut


class DeviceLut:
    """``Lut.values`` on a device; out-of-domain inputs give 0, like
    ``Lut.apply_np`` (quantize/luts.py)."""

    def __init__(self, lut: Lut, device):
        self.lut = lut
        self.lo, self.hi = int(lut.lo), int(lut.hi)
        self.values = torch.as_tensor(lut.values, dtype=torch.int32,
                                      device=device)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        in_dom = (x >= self.lo) & (x <= self.hi)
        idx = torch.clamp(x.to(torch.int64) - self.lo, 0, self.hi - self.lo)
        return torch.where(in_dom, self.values[idx],
                           torch.zeros((), dtype=torch.int32,
                                       device=x.device))

    def apply_clipped(self, x: torch.Tensor) -> torch.Tensor:
        """apply() for inputs known to lie inside [lo, hi] (the SiLU
        epilogue's clipped sigmoid domain)."""
        return self.values[x.to(torch.int64) - self.lo]
