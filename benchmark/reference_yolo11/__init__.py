"""The plain reference of the YOLO11 configurations (benchmark/spec.py's
interface): plain PyTorch and NumPy, importing nothing of the program or
of JAX, and reusing what does not depend on the topology from
benchmark.reference."""
