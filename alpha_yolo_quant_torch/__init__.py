"""PyTorch/CUDA port of alpha_yolo_quant_tpu for one NVIDIA H100.

The JAX package is the reference: both consume the same host-side numpy
``QuantizedModel`` (alpha_yolo_quant_tpu.quantize.transform), whose
modules import no JAX and are reused here by import. This package imports
``torch`` and never ``jax``. The integer convolutions run on hand-written
Hopper kernels (runtime/csrc, bound in runtime/fused_ops.py); on CPU
tensors every kernel wrapper runs its plain PyTorch version instead.
"""
