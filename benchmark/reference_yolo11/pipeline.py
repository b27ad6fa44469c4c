"""The plain reference of the YOLO11 serving pipeline: uint8 images ->
detections ``(det (B, max_det, 6) float32, n_det (B,) int32)``, as numpy.

benchmark/reference/pipeline.py's ``requant``, ``lut``, input
quantization, dense full-quant decode over p3-p5 (``decode``) and q_NMS
of one image (``q_nms_one``) serve YOLO11 as they are. The integer
forward is its own, over the node classes of reference_yolo11/graph.py:

- every conv is exact, F.conv2d in float64 with cuDNN off (a depthwise
  conv with groups = its channels), then every requant in int64: the SiLU
  chain, the plain conv's one requant to int8, or nothing on the head's
  Conv2d;
- an attention node, per image and head over the N pixels: L = q^T k
  (exact, a float64 product of integers), Lq = requant(L) to 8 bits,
  e = exp_lut[Lq - rowmax(Lq)], S = sum_m e, A = sum_m e * v (exact),
  out = requant(floor(A / S)) to K bits: the softmax normalised after the
  product, with a true integer floor.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.graph import (
    ConcatNode, MaxPoolNode, ResidualAddNode, SplitNode, UpsampleNode,
)
from benchmark.reference.pipeline import (
    _i64, decode, lut, q_nms_one, quantize_images, requant,
)
from benchmark.reference_yolo11.graph import AttentionNode, ConvNode
from benchmark.reference_yolo11.quant import AttnQ, QModel11


def conv_exact(x: torch.Tensor, w: torch.Tensor, stride: int, padding: int,
               groups: int) -> torch.Tensor:
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x.to(torch.float64), w, stride=stride,
                       padding=padding, groups=groups)
    return acc.to(torch.int64)


def attention(a: AttnQ, qkv: torch.Tensor, qmax: int):
    """The attention's integer contract on NCHW int64 codes: (out, v)."""
    n = a.node
    b, _, hh, ww = qkv.shape
    t = qkv.reshape(b, n.heads, 2 * n.key_dim + n.head_dim, hh * ww)
    q, k, v = t.split([n.key_dim, n.key_dim, n.head_dim], dim=2)
    logits = (q.transpose(2, 3).to(torch.float64)
              @ k.to(torch.float64)).to(torch.int64)       # (b, h, N, N)
    lq = requant(logits, a.logit_r, a.logit_s, 127)
    e = lut(a.exp_lut, lq - lq.amax(dim=3, keepdim=True))
    acc = (v.to(torch.float64) @ e.transpose(2, 3).to(torch.float64)) \
        .to(torch.int64)                                    # (b, h, hd, N)
    o = torch.div(acc, e.sum(dim=3)[:, :, None, :], rounding_mode="floor")
    out = requant(o, a.out_r, a.out_s, qmax)
    return out.reshape(b, -1, hh, ww), v.reshape(b, -1, hh, ww)


def int_forward(model: QModel11,
                x_q: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The integer graph on NCHW int64 codes -> the six raw head
    accumulators by role (int64)."""
    qmax = model.cfg.qmax
    dev = x_q.device
    graph = model.graph
    last_use: Dict[str, int] = {}
    for i, node in enumerate(graph.nodes):
        for e in _srcs(node):
            last_use[e] = i
    env = {graph.input_edge: x_q}
    sig = model.sig_lut
    ch = (1, -1, 1, 1)
    for idx, node in enumerate(graph.nodes):
        if isinstance(node, ConvNode):
            c = model.convs[node.name]
            if (np.abs(c.w_q).reshape(len(c.w_q), -1).sum(1).max()
                    * max(model.edge_amax[node.src], 1) >= 2 ** 52):
                raise ValueError(f"{node.name}: float64 conv not exact")
            acc = conv_exact(env[node.src],
                             torch.as_tensor(c.w_q, dtype=torch.float64,
                                             device=dev),
                             node.stride, node.padding, node.groups)
            acc = acc + _i64(c.b_q, dev).reshape(ch)
            if node.silu:
                dom = requant(acc, _i64(c.r1, dev).reshape(ch),
                              _i64(c.s1, dev).reshape(ch), qmax)
                out = requant(lut(sig, dom) * acc,
                              _i64(c.r2, dev).reshape(ch),
                              _i64(c.s2, dev).reshape(ch), qmax)
            elif c.r2 is not None:
                out = requant(acc, _i64(c.r2, dev).reshape(ch),
                              _i64(c.s2, dev).reshape(ch), qmax)
            else:
                out = acc
            env[node.dst] = out
        elif isinstance(node, AttentionNode):
            env[node.dst], env[node.v_dst] = attention(
                model.attns[node.name], env[node.src], qmax)
        elif isinstance(node, SplitNode):
            h = env[node.src].shape[1] // 2
            env[node.dst1] = env[node.src][:, :h]
            env[node.dst2] = env[node.src][:, h:]
        elif isinstance(node, ResidualAddNode):
            r, s = model.requants[(idx, node.src)]
            out = requant(env[node.src], r, s, qmax) + env[node.base]
            bound = model.clip_after_residual.get(idx)
            if bound is not None:
                out = torch.clamp(out, -bound, bound)
            env[node.dst] = out
        elif isinstance(node, ConcatNode):
            parts = []
            for e in node.srcs:
                t = env[e]
                if (idx, e) in model.requants:
                    r, s = model.requants[(idx, e)]
                    t = requant(t, r, s, qmax)
                parts.append(t)
            env[node.dst] = torch.cat(parts, 1)
        elif isinstance(node, MaxPoolNode):
            env[node.dst] = F.max_pool2d(
                env[node.src].to(torch.float64), node.kernel, node.stride,
                node.padding).to(torch.int64)
        elif isinstance(node, UpsampleNode):
            f = node.factor
            env[node.dst] = env[node.src].repeat_interleave(
                f, 2).repeat_interleave(f, 3)
        for e in _srcs(node):
            if last_use.get(e) == idx and e not in graph.outputs.values():
                env.pop(e, None)
    return {role: env[e] for role, e in graph.outputs.items()}


def _srcs(node):
    if isinstance(node, ConcatNode):
        return node.srcs
    if isinstance(node, ResidualAddNode):
        return (node.src, node.base)
    return (node.src,)


def detect(model: QModel11, images: np.ndarray, nms: Dict, device="cpu",
           block: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Images (B, 3, H, W) -> (det (B, max_det, 6), n_det (B,)), the convs
    on ``device`` in blocks of ``block`` images, decode and q_NMS on the
    host."""
    dets, ns = [], []
    for i in range(0, len(images), block):
        x = torch.as_tensor(quantize_images(images[i:i + block], model.cfg.k),
                            device=device)
        acc = {r: t.cpu() for r, t in int_forward(model, x).items()}
        xywh, cls = decode(model, acc)
        for j in range(xywh.shape[0]):
            det, n = q_nms_one(model, xywh[j], cls[j], nms)
            dets.append(det)
            ns.append(n)
    return np.stack(dets), np.asarray(ns, np.int32)
