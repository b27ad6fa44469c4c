"""Build the shared ``QuantizedModel`` without loading JAX.

``alpha_yolo_quant_tpu.quantize.transform.build_quantized_model`` is host
numpy, but its fold-eligibility check imports one constant, ``I15_MAX``,
from ``alpha_yolo_quant_tpu/ops/intmath.py`` (transform.py:154), and that
module imports jax at the top, so it fails where JAX is not installed.
While that module is not loaded, this wrapper serves the constant from a
stand-in module for the duration of the call and removes it afterwards,
so a process that later imports the real module gets the real one.
"""

from __future__ import annotations

import sys
import types

from alpha_yolo_quant_tpu.quantize import transform as _transform

_INTMATH = "alpha_yolo_quant_tpu.ops.intmath"
I15_MAX = 1 << 15   # alpha_yolo_quant_tpu/ops/intmath.py:27


def build_quantized_model(*args, **kwargs):
    """``alpha_yolo_quant_tpu.quantize.transform.build_quantized_model``,
    same arguments, same result."""
    if _INTMATH in sys.modules:
        return _transform.build_quantized_model(*args, **kwargs)
    stand_in = types.ModuleType(_INTMATH)
    stand_in.I15_MAX = I15_MAX
    sys.modules[_INTMATH] = stand_in
    try:
        return _transform.build_quantized_model(*args, **kwargs)
    finally:
        if sys.modules.get(_INTMATH) is stand_in:
            del sys.modules[_INTMATH]
