"""The plain reference of the serving pipeline: uint8 images ->
detections ``(det (B, max_det, 6) float32, n_det (B,) int32)``, as numpy.

Plain PyTorch, written from the hardware contract (the benchmark's frozen
copy of alpha_yolo_quant_torch/runtime/golden.py, the dense full-quant
decode and q_NMS), importing nothing of the program:

- input: u/255 in float32 (float32 images as they are), clip to [-1, 1], times qmax, half-to-even;
- every conv is exact: F.conv2d in float64 with cuDNN off (im2col and a
  GEMM), where every product and partial sum is an integer far below
  2^53, so any summation order gives the int64 accumulator; then every
  requant in int64, ``clip(rhu((r * x) >> (s - 1)))``;
- the head: 8-bit box and 16-bit class requants, the LUT-exponent DFL
  softmax with an integer floor, the DFL requant to the anchor scale,
  quantized anchors, boxes in float32;
- q_NMS with the deferred sigmoid (the serving default): candidates
  ranked by the raw integer class score (lowest class, then lowest anchor
  first on ties), cut to pre_topk, kept if above the pre-sigmoid form of
  the confidence threshold, then sequential greedy suppression by the
  quantized predicate ``m * inter > a_i + a_j - m * inter`` in float32
  with boxes offset by class, at most max_det kept; the 16-bit sigmoid
  only on the kept rows.

It runs on any device; on the card, cuDNN is switched off around the
convs only.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.graph import (
    ConcatNode, ConvNode, MaxPoolNode, ResidualAddNode, SplitNode,
    UpsampleNode,
)
from benchmark.reference.quant import QModel

STRIDES = (8, 16, 32)


def quantize_images(images: np.ndarray, k: int) -> np.ndarray:
    """NCHW images, uint8 pixels or float32 in [0, 1] -> int64 K-bit input
    codes."""
    qmax = 2 ** (k - 1) - 1
    x = images.astype(np.float32)
    if images.dtype == np.uint8:
        x = x / np.float32(255.0)
    return np.int64(np.round(np.clip(x, -1, 1) * np.float32(qmax)))


def _i64(v, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.int64), device=device)


def requant(x: torch.Tensor, r, s, qmax: int) -> torch.Tensor:
    """clip(rhu((r * x) >> (s - 1)), +-qmax), int64; r and s broadcast."""
    q = (r * x) >> (s - 1)
    return torch.clamp((q >> 1) + (q & 1), -qmax, qmax)


def lut(table, x: torch.Tensor) -> torch.Tensor:
    vals = _i64(table.values, x.device)
    inside = (x >= table.lo) & (x <= table.hi)
    idx = torch.clamp(x - table.lo, 0, table.hi - table.lo)
    return torch.where(inside, vals[idx], torch.zeros_like(x))


def conv_exact(x: torch.Tensor, w: torch.Tensor, stride: int,
               padding: int) -> torch.Tensor:
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(x.to(torch.float64), w, stride=stride,
                       padding=padding)
    return acc.to(torch.int64)


def int_forward(model: QModel, x_q: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The integer graph on NCHW int64 codes -> the six raw head
    accumulators by role (int64)."""
    cfg = model.cfg
    qmax = cfg.qmax
    dev = x_q.device
    graph = model.graph
    last_use: Dict[str, int] = {}
    for i, node in enumerate(graph.nodes):
        for e in _srcs(node):
            last_use[e] = i
    env = {graph.input_edge: x_q}
    sig = model.sig_lut
    for idx, node in enumerate(graph.nodes):
        if isinstance(node, ConvNode):
            c = model.convs[node.name]
            if (np.abs(c.w_q).reshape(len(c.w_q), -1).sum(1).max()
                    * max(model.edge_amax[node.src], 1) >= 2 ** 52):
                raise ValueError(f"{node.name}: float64 conv not exact")
            acc = conv_exact(env[node.src],
                             torch.as_tensor(c.w_q, dtype=torch.float64,
                                             device=dev),
                             node.stride, node.padding)
            acc = acc + _i64(c.b_q, dev).reshape(1, -1, 1, 1)
            if node.silu:
                ch = (1, -1, 1, 1)
                dom = requant(acc, _i64(c.r1, dev).reshape(ch),
                              _i64(c.s1, dev).reshape(ch), qmax)
                sigma = lut(sig, dom)
                out = requant(sigma * acc, _i64(c.r2, dev).reshape(ch),
                              _i64(c.s2, dev).reshape(ch), qmax)
            else:
                out = acc
            env[node.dst] = out
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


def decode(model: QModel, acc: Dict[str, torch.Tensor]):
    """Raw head accumulators -> (boxes xywh (B, N, 4) float32 in anchor-scale
    units, raw integer class scores (B, 80, N) int64)."""
    h = model.head
    dev = acc["p3_box"].device
    boxes, clss = [], []
    for li, level in enumerate(("p3", "p4", "p5")):
        ch = (1, -1, 1, 1)
        bq = requant(acc[f"{level}_box"], _i64(h.box_r[level], dev).reshape(ch),
                     _i64(h.box_s[level], dev).reshape(ch), 127)
        cq = requant(acc[f"{level}_cls"], _i64(h.cls_r[level], dev).reshape(ch),
                     _i64(h.cls_s[level], dev).reshape(ch), 2 ** 15 - 1)
        b, _, hh, ww = bq.shape
        bins = bq.reshape(b, 4, 16, hh * ww)
        e = lut(h.exp_lut, bins - bins.amax(dim=2, keepdim=True))
        ssum = torch.clamp(e.sum(dim=2, keepdim=True), min=1)
        p = torch.div(127 * e, ssum, rounding_mode="floor")
        dist = requant((p * _i64(h.dfl_w_q, dev).reshape(1, 1, 16, 1)).sum(2),
                       h.dfl_r, h.dfl_s, 2 ** 15 - 1).to(torch.float32)
        sx = torch.arange(ww, dtype=torch.float32, device=dev) + 0.5
        sy = torch.arange(hh, dtype=torch.float32, device=dev) + 0.5
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        anc = torch.round(torch.stack((gx.reshape(-1), gy.reshape(-1)), 0)
                          * h.anchor_scale)[None]            # (1, 2, n)
        x1y1 = anc - dist[:, :2]
        x2y2 = anc + dist[:, 2:]
        xywh = torch.cat(((x1y1 + x2y2) / 2, x2y2 - x1y1), 1) \
            * float(STRIDES[li])
        boxes.append(xywh)
        clss.append(cq.reshape(b, 80, hh * ww))
    return torch.cat(boxes, 2).transpose(1, 2), torch.cat(clss, 2)


def conf_threshold(model: QModel, conf_thres_int: int) -> float:
    """The raw class score above which the 16-bit sigmoid passes
    ``conf_thres_int``, minus 0.5."""
    t = model.head.cls_sig_lut
    above = np.nonzero(t.values > conf_thres_int)[0]
    return float(t.hi) + 0.5 if len(above) == 0 else \
        float(above[0] + t.lo) - 0.5


def q_nms_one(model: QModel, xywh: torch.Tensor, cls: torch.Tensor,
              nms: Dict) -> Tuple[np.ndarray, int]:
    """One image: xywh (N, 4) float32, raw class scores (80, N) int64 ->
    (det (max_det, 6) float32, n_det)."""
    h = model.head
    n = cls.shape[1]
    conf = cls.amax(dim=0)
    cid = (cls == conf).to(torch.int8).argmax(dim=0)   # the lowest class
    idx = torch.sort(-conf, stable=True).indices[:min(nms["pre_topk"], n)]
    thr = conf_threshold(model, nms["conf_thres_int"])
    valid = (conf[idx].to(torch.float32) > thr).numpy()
    b = xywh[idx]
    dw, dh = b[:, 2] / 2, b[:, 3] / 2
    xyxy = torch.stack((b[:, 0] - dw, b[:, 1] - dh, b[:, 0] + dw,
                        b[:, 1] + dh), 1)
    c_cls = cid[idx].to(torch.float32)
    x1, y1, x2, y2 = (xyxy + (c_cls * float(nms["max_wh"]))[:, None]).unbind(1)
    one = float(int(round(h.anchor_scale)))
    area = (x2 - x1 + one) * (y2 - y1 + one)
    w = torch.clamp(torch.minimum(x2[:, None], x2[None])
                    - torch.maximum(x1[:, None], x1[None]) + one, min=0.0)
    hh = torch.clamp(torch.minimum(y2[:, None], y2[None])
                     - torch.maximum(y1[:, None], y1[None]) + one, min=0.0)
    t = (w * hh) * torch.tensor(round(1.0 / nms["iou_thres"], 2),
                                dtype=torch.float32)
    sup = (t > (area[:, None] + area[None]) - t).numpy()   # j suppresses i
    kept = []
    killed = np.zeros(len(valid), bool)
    for i in range(len(valid)):
        if valid[i] and not killed[i]:
            kept.append(i)
            if len(kept) == nms["max_det"]:
                break
            killed |= sup[i]
    det = np.zeros((nms["max_det"], 6), np.float32)
    if kept:
        k = torch.as_tensor(kept)
        box_r = torch.tensor(1.0) / torch.tensor(h.anchor_scale,
                                                 dtype=torch.float32)
        score_r = torch.tensor(1.0) / torch.tensor(32767.0)
        sig = lut(h.cls_sig_lut, conf[idx][k]).to(torch.int32)
        rows = torch.cat((xyxy[k] * box_r, (sig * score_r)[:, None],
                          c_cls[k][:, None]), 1)
        det[:len(kept)] = rows.numpy()
    return det, len(kept)


def detect(model: QModel, images: np.ndarray, nms: Dict, device="cpu",
           block: int = 4) -> Tuple[np.ndarray, np.ndarray]:
    """Images (B, 3, H, W) -> (det (B, max_det, 6), n_det (B,)),
    the convs on ``device`` in blocks of ``block`` images, decode and
    q_NMS on the host."""
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
