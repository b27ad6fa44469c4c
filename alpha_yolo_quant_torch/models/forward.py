"""Float forward over the graph IR, with calibration taps (counterpart of
alpha_yolo_quant_tpu/models/forward.py)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from alpha_yolo_quant_torch.models.graph import (
    AttentionNode, ConcatNode, ConvNode, Graph, MaxPoolNode, ResidualAddNode,
    SplitNode, UpsampleNode,
)
from alpha_yolo_quant_torch.ops.nn import (
    attention_f32, conv2d_f32, maxpool2d, silu, upsample_nearest,
)


def forward_float(graph: Graph, params: Dict[str, Dict[str, torch.Tensor]],
                  x: torch.Tensor, collect_taps: bool = False,
                  capture: Optional[Dict[str, torch.Tensor]] = None,
                  conv=conv2d_f32
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Run the fp32 model on NCHW images.

    Returns (outputs, taps): the six raw head tensors by role, and with
    collect_taps the per-image max-abs of every conv's pre-activation
    output by tap name (plus 'start' for the input), and of each
    attention node's logits and output under its tap and out_tap.
    ``capture``: a dict whose keys are tap names; each is set to that
    conv's whole pre-activation output. ``conv(x, w, b, stride,
    padding)`` runs each dense conv (the tensor-parallel forward of
    parallel/mesh.py passes one that computes this rank's output channels
    and gathers the rest); a depthwise conv runs whole here.

    On CUDA this turns TF32 off for convolutions and matmuls
    (torch.backends.cudnn.allow_tf32 and
    torch.backends.cuda.matmul.allow_tf32 = False): TF32 keeps about three
    decimal digits and calibration needs float32.
    """
    if x.is_cuda:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    env: Dict[str, torch.Tensor] = {graph.input_edge: x}
    taps: Dict[str, torch.Tensor] = {}

    def record(name, t):
        if collect_taps and name is not None:
            m = torch.amax(torch.abs(t), dim=(1, 2, 3))
            taps[name] = torch.maximum(taps[name], m) if name in taps else m

    record("start", x)
    for node in graph.nodes:
        if isinstance(node, ConvNode):
            p = params[node.key]
            if node.groups > 1:
                out = conv2d_f32(env[node.src], p["w"], p["b"], node.stride,
                                 node.padding, node.groups)
            else:
                out = conv(env[node.src], p["w"], p["b"], node.stride,
                           node.padding)
            record(node.tap, out)
            if capture is not None and node.tap in capture:
                capture[node.tap] = out
            env[node.dst] = silu(out) if node.silu else out
        elif isinstance(node, SplitNode):
            h = env[node.src].shape[1] // 2
            env[node.dst1] = env[node.src][:, :h]
            env[node.dst2] = env[node.src][:, h:]
        elif isinstance(node, ResidualAddNode):
            env[node.dst] = env[node.src] + env[node.base]
        elif isinstance(node, ConcatNode):
            env[node.dst] = torch.cat([env[e] for e in node.srcs], dim=1)
        elif isinstance(node, MaxPoolNode):
            env[node.dst] = maxpool2d(env[node.src], node.kernel,
                                      node.stride, node.padding)
        elif isinstance(node, UpsampleNode):
            env[node.dst] = upsample_nearest(env[node.src], node.factor)
        elif isinstance(node, AttentionNode):
            logits, out, v = attention_f32(env[node.src], node.heads,
                                           node.key_dim, node.head_dim)
            record(node.tap, logits)
            record(node.out_tap, out)
            env[node.dst], env[node.v_dst] = out, v
        else:  # pragma: no cover
            raise TypeError(type(node))
    outputs = {role: env[e] for role, e in graph.outputs.items()}
    return outputs, taps
