"""Parallel execution on torch.distributed process groups (counterpart of
alpha_yolo_quant_tpu/parallel/): batch data parallelism (dp), tensor
parallelism over conv output channels (tp), height-banded spatial
parallelism (sp), GPipe pipeline parallelism (pp), and their 2-D meshes.
Every sharded integer path equals the unsharded one bit for bit."""
