"""The plain float32 calibration forward of the YOLO11 graph: the per-tap
max-abs of every conv's pre-activation output, and of each attention
node's logits (tap) and output (out_tap), as ultralytics' Attention
computes them. TF32 is off for the convs and the attention's products."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from benchmark.reference.graph import (
    ConcatNode, Graph, MaxPoolNode, ResidualAddNode, SplitNode, UpsampleNode,
)
from benchmark.reference_yolo11.graph import AttentionNode, ConvNode


@torch.no_grad()
def calibration_taps(graph: Graph, params: Dict, x: torch.Tensor
                     ) -> Dict[str, float]:
    """NCHW float32 images -> tap -> max-abs over the images, plus
    ``start`` = 1 (the input scale is pinned to a = 1). ``params`` are
    numpy float32 arrays. The process's TF32 settings are restored after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return _taps(graph, params, x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


def attention(qkv: torch.Tensor, node: AttentionNode):
    """ultralytics Attention.forward up to the pe sum: (logits, out, v),
    out and v NCHW in channel h * head_dim + d."""
    b, _, h, w = qkv.shape
    q, k, v = qkv.view(b, node.heads, 2 * node.key_dim + node.head_dim,
                       h * w).split([node.key_dim, node.key_dim,
                                     node.head_dim], dim=2)
    logits = (q.transpose(-2, -1) @ k) * node.key_dim ** -0.5
    out = (v @ logits.softmax(dim=-1).transpose(-2, -1)).view(b, -1, h, w)
    return logits, out, v.reshape(b, -1, h, w)


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
                           stride=node.stride, padding=node.padding,
                           groups=node.groups)
            taps[node.tap] = float(out.abs().max())
            env[node.dst] = out * torch.sigmoid(out) if node.silu else out
        elif isinstance(node, AttentionNode):
            logits, out, v = attention(env[node.src], node)
            taps[node.tap] = float(logits.abs().max())
            taps[node.out_tap] = float(out.abs().max())
            env[node.dst], env[node.v_dst] = out, v
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
