"""The plain float32 forward over the graph, for calibration: the per-tap
max-abs of every conv's pre-activation output (the benchmark's frozen copy
of alpha_yolo_quant_torch/models/forward.py with its taps). TF32 is off:
calibration needs float32."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.graph import (
    ConcatNode, ConvNode, Graph, MaxPoolNode, ResidualAddNode, SplitNode,
    UpsampleNode,
)


@torch.no_grad()
def calibration_taps(graph: Graph, params: Dict, x: torch.Tensor
                     ) -> Dict[str, float]:
    """NCHW float32 images -> tap -> max-abs over the images of that conv's
    pre-activation output, plus ``start`` = 1 (the input scale is pinned to
    a = 1). ``params`` are numpy float32 arrays. TF32 is off for these
    convs alone: the process's settings are left as they were."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        return _taps(graph, params, x)


def _taps(graph: Graph, params: Dict, x: torch.Tensor) -> Dict[str, float]:
    dev = x.device
    env = {graph.input_edge: x}
    taps: Dict[str, float] = {"start": 1.0}
    for node in graph.nodes:
        if isinstance(node, ConvNode):
            p = params[node.key]
            out = F.conv2d(env[node.src],
                           torch.as_tensor(p["w"], device=dev),
                           torch.as_tensor(p["b"], device=dev),
                           stride=node.stride, padding=node.padding)
            taps[node.tap] = float(out.abs().max())
            env[node.dst] = out * torch.sigmoid(out) if node.silu else out
        elif isinstance(node, SplitNode):
            h = env[node.src].shape[1] // 2
            env[node.dst1] = env[node.src][:, :h]
            env[node.dst2] = env[node.src][:, h:]
        elif isinstance(node, ResidualAddNode):
            env[node.dst] = env[node.src] + env[node.base]
        elif isinstance(node, ConcatNode):
            env[node.dst] = torch.cat([env[e] for e in node.srcs], 1)
        elif isinstance(node, MaxPoolNode):
            env[node.dst] = F.max_pool2d(env[node.src], node.kernel,
                                         node.stride, node.padding)
        elif isinstance(node, UpsampleNode):
            f = node.factor
            env[node.dst] = env[node.src].repeat_interleave(
                f, 2).repeat_interleave(f, 3)
    return taps
