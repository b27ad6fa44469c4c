"""The reference's configuration of the YOLO11 scales, written from
ultralytics/cfg/models/11/yolo11.yaml: ``scales`` gives each scale's
[depth, width, max_channels]; ``ratio`` is max_channels / 512, the form
benchmark/run.check_config reads (the cap is ``512 * ratio``). The
quantizer's constants are the hardware contract's, as in
benchmark/reference/config.py."""

from __future__ import annotations

import dataclasses
from typing import Optional

# yolo11.yaml scales: depth, width, max_channels
SCALES = {
    "yolo11n": (0.50, 0.25, 1024),
    "yolo11s": (0.50, 0.50, 1024),
    "yolo11m": (0.50, 1.00, 512),
    "yolo11l": (1.00, 1.00, 512),
    "yolo11x": (1.00, 1.50, 512),
}


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """A YOLO11 model at bit width ``k`` on square images of
    ``image_size`` pixels (a multiple of 32, the deepest stride). Full
    quant only: the reference serves the full-quant pipeline."""

    model: str = "yolo11m"
    k: int = 8
    full_quant: bool = True
    image_size: int = 640
    koeff_bits: int = 8
    sigmoid_domain: Optional[float] = None
    dfl_max: float = 14.8264799118042
    cls_sigmoid_max: float = 12.0
    cls_sigmoid_bits: int = 16

    def __post_init__(self):
        if self.model not in SCALES:
            raise ValueError(f"unknown YOLO11 model {self.model!r}")
        if not 2 <= self.k <= 8:
            raise ValueError(f"k={self.k}: 2 <= K <= 8")
        if self.image_size % 32:
            raise ValueError(f"image size {self.image_size} is not a "
                             "multiple of 32")

    @property
    def scale(self) -> str:
        """The scale's letter: n, s, m, l or x."""
        return self.model[-1]

    @property
    def depth(self) -> float:
        return SCALES[self.model][0]

    @property
    def width(self) -> float:
        return SCALES[self.model][1]

    @property
    def max_channels(self) -> int:
        return SCALES[self.model][2]

    @property
    def ratio(self) -> float:
        return self.max_channels / 512

    @property
    def qmax(self) -> int:
        return 2 ** (self.k - 1) - 1

    @property
    def sigmoid_lut_domain(self) -> float:
        """The SiLU sigmoid LUT's domain: 6 in full quant, 7 in partial."""
        if self.sigmoid_domain is not None:
            return self.sigmoid_domain
        return 6.0 if self.full_quant else 7.0
