"""PyTorch/CUDA port of alpha_yolo_quant_tpu for one NVIDIA H100.

The JAX package is the reference. This package keeps its own copies of
the host-side numpy modules it needs (config, graph IR, params, the
quantize transform, LUTs, the golden int64 oracle, the artifact
exporters and loaders, the mAP metric and its oracle), so it imports
``torch`` and never ``jax`` or ``alpha_yolo_quant_tpu``. The integer
convolutions and epilogues run on hand-written Hopper kernels
(runtime/csrc, bound in runtime/fused_ops.py); on CPU tensors every
kernel wrapper runs its plain PyTorch version instead.
"""
