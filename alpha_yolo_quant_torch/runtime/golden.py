"""NumPy int64 golden runtime — the host oracle (stage-6 analog).

Executes the quantized graph with plain numpy int64 and the float64
requantization semantics of quantize/primitives.requantize_np. This is the
runtime the Verilog testbench artifacts are generated from, and the oracle
the device runtimes are tested bit-exact against (the reference's
equivalent is quantisation/stage_6.py run on one golden image).

The port's own copy of alpha_yolo_quant_tpu/runtime/golden.py,
numpy logic unchanged.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from alpha_yolo_quant_torch.models.graph import (
    ConcatNode, ConvNode, MaxPoolNode, ResidualAddNode, SplitNode,
    UpsampleNode,
)
from alpha_yolo_quant_torch.quantize.primitives import requantize_np, scale_for
from alpha_yolo_quant_torch.quantize.transform import QuantizedModel


def conv2d_int64(x: np.ndarray, w: np.ndarray, stride: int,
                 padding: int) -> np.ndarray:
    """Integer conv via padded sliding windows (int64 exact)."""
    if padding:
        x = np.pad(x, ((0, 0), (0, 0), (padding, padding),
                       (padding, padding)))
    kh, kw = w.shape[2], w.shape[3]
    win = np.lib.stride_tricks.sliding_window_view(x, (kh, kw), axis=(2, 3))
    win = win[:, :, ::stride, ::stride]                    # (N,C,H',W',kh,kw)
    return np.einsum("nchwij,ocij->nohw", win.astype(np.int64),
                     w.astype(np.int64), optimize=True)


def maxpool_int64(x: np.ndarray, kernel: int, stride: int,
                  padding: int) -> np.ndarray:
    lo = np.iinfo(np.int64).min
    if padding:
        x = np.pad(x, ((0, 0), (0, 0), (padding, padding),
                       (padding, padding)), constant_values=lo)
    win = np.lib.stride_tricks.sliding_window_view(x, (kernel, kernel),
                                                   axis=(2, 3))
    return win[:, :, ::stride, ::stride].max(axis=(4, 5))


def quantize_input_np(x: np.ndarray, k: int) -> np.ndarray:
    """Input quantization contract: float32 multiply + half-even round
    (preprocessing happens in f32 on device; identical to
    runtime.interpreter.quantize_input)."""
    qmax = 2 ** (k - 1) - 1
    return np.int64(np.round(np.clip(x.astype(np.float32), -1, 1)
                             * np.float32(qmax)))


def golden_forward(model: QuantizedModel, x: np.ndarray,
                   quantize: bool = True) -> Dict[str, np.ndarray]:
    """Run the golden int64 pipeline; returns every edge plus
    '<name>:sigdom' / requant intermediates, head accumulators under role
    names — same env naming as runtime.interpreter.int_forward."""
    cfg = model.cfg
    k = cfg.k
    sig_scale = scale_for(cfg.sigmoid_lut_domain, k)
    env: Dict[str, np.ndarray] = {
        model.graph.input_edge:
            quantize_input_np(x, k) if quantize else np.int64(x)}

    for idx, node in enumerate(model.graph.nodes):
        if isinstance(node, ConvNode):
            c = model.convs[node.name]
            acc = conv2d_int64(env[node.src], c.w_q, node.stride,
                               node.padding)
            acc = acc + np.int64(c.b_q).reshape(1, -1, 1, 1)
            if node.silu:
                dom, _, _ = requantize_np(acc, c.acc_scale, sig_scale, k,
                                          cfg.koeff_bits)
                env[f"{node.name}:sigdom"] = dom
                sigma = model.sig_lut.apply_np(dom)
                prod = sigma * acc
                out, _, _ = requantize_np(
                    prod, scale_for(1.0, k) * c.acc_scale, c.out_scale, k,
                    cfg.koeff_bits)
                env[node.dst] = out
            else:
                env[node.dst] = acc
        elif isinstance(node, SplitNode):
            h = env[node.src].shape[1] // 2
            env[node.dst1] = env[node.src][:, :h]
            env[node.dst2] = env[node.src][:, h:]
        elif isinstance(node, ResidualAddNode):
            rq = model.requants[(idx, node.src)]
            req, _, _ = requantize_np(env[node.src], rq.old_scale,
                                      rq.new_scale, k, cfg.koeff_bits)
            env[f"{node.label}:rescale"] = req
            out = req + env[node.base]
            bound = model.clip_after_residual.get(idx)
            if bound is not None:
                out = np.clip(out, -bound, bound)
            env[node.dst] = out
        elif isinstance(node, ConcatNode):
            parts = []
            for e in node.srcs:
                t = env[e]
                if (idx, e) in model.requants:
                    rq = model.requants[(idx, e)]
                    t, _, _ = requantize_np(t, rq.old_scale, rq.new_scale,
                                            k, cfg.koeff_bits)
                    env[f"{node.label}:{e}:requant"] = t
                parts.append(t)
            env[node.dst] = np.concatenate(parts, axis=1)
        elif isinstance(node, MaxPoolNode):
            env[node.dst] = maxpool_int64(env[node.src], node.kernel,
                                          node.stride, node.padding)
        elif isinstance(node, UpsampleNode):
            env[node.dst] = np.repeat(
                np.repeat(env[node.src], node.factor, axis=2),
                node.factor, axis=3)

    for role, e in model.graph.outputs.items():
        env[role] = env[e]
    return env


def _np_make_anchors(shapes, strides=(8, 16, 32), offset=0.5):
    pts, strs = [], []
    for (h, w), s in zip(shapes, strides):
        sx = np.arange(w, dtype=np.float64) + offset
        sy = np.arange(h, dtype=np.float64) + offset
        gy, gx = np.meshgrid(sy, sx, indexing="ij")
        pts.append(np.stack((gx.reshape(-1), gy.reshape(-1)), 0))
        strs.append(np.full((1, h * w), s, np.float64))
    return np.concatenate(pts, 1), np.concatenate(strs, 1)


def _np_dist2bbox(distance, anchors):
    lt, rb = np.split(distance, 2, axis=1)
    x1y1 = anchors - lt
    x2y2 = anchors + rb
    return np.concatenate(((x1y1 + x2y2) / 2, x2y2 - x1y1), 1)


def decode_partial_np(model: QuantizedModel, env: Dict) -> np.ndarray:
    """Partial-quant float64 head (the stage-6 tail, reference
    stage_6.py:598-634): dequantize the six accumulators, float softmax +
    DFL + sigmoid. Returns (B, 84, N)."""
    from alpha_yolo_quant_torch.runtime.interpreter import head_conv_name

    deq = {}
    shapes = []
    for role in model.graph.outputs:
        acc = np.float64(env[role])
        deq[role] = acc / model.convs[head_conv_name(role)].acc_scale
    boxes = [deq[f"{l}_box"] for l in ("p3", "p4", "p5")]
    clss = [deq[f"{l}_cls"] for l in ("p3", "p4", "p5")]
    shapes = [(t.shape[2], t.shape[3]) for t in boxes]
    anchors, strides = _np_make_anchors(shapes)
    b = boxes[0].shape[0]
    box = np.concatenate([t.reshape(b, 64, -1) for t in boxes], 2)
    n = box.shape[2]
    bins = box.reshape(b, 4, 16, n)
    e = np.exp(bins - bins.max(axis=2, keepdims=True))
    probs = e / e.sum(axis=2, keepdims=True)
    dfl_w = np.arange(16, dtype=np.float64)
    dfl = np.einsum("bcrn,r->bcn", probs, dfl_w)
    dbox = _np_dist2bbox(dfl, anchors[None]) * strides
    cls = np.concatenate([t.reshape(b, 80, -1) for t in clss], 2)
    cls = 1 / (1 + np.exp(-cls))
    return np.concatenate((dbox, cls), 1)


def head_intermediates_np(model: QuantizedModel, env: Dict) -> Dict:
    """The 6b head tail with every intermediate the reference exports
    (stage_6_full_quant.py:596-761): per-level 8-bit box requants and
    16-bit cls requants with their rescale/shift arrays, the integer
    softmax probabilities ``p``, and the DFL output requantized to the
    anchor scale (4D via the reference's (1,1,1,1)-scale broadcast)."""
    from alpha_yolo_quant_torch.runtime.interpreter import head_conv_name

    h = model.head
    out: Dict = {"levels": {}}
    boxes, clss, shapes = [], [], []
    for level in ("p3", "p4", "p5"):
        bacc = np.int64(env[f"{level}_box"])
        cacc = np.int64(env[f"{level}_cls"])
        shapes.append((bacc.shape[2], bacc.shape[3]))
        up = model.convs[head_conv_name(f"{level}_box")]
        dn = model.convs[head_conv_name(f"{level}_cls")]
        bq, b_r, b_s = requantize_np(bacc, up.acc_scale, h.box_scale, 8,
                                     model.cfg.koeff_bits)
        cq, c_r, c_s = requantize_np(cacc, dn.acc_scale, h.cls_scale, 16,
                                     model.cfg.koeff_bits)
        out["levels"][level] = {"bq": bq, "b_r": b_r, "b_s": b_s,
                                "cq": cq, "c_r": c_r, "c_s": c_s}
        b = bq.shape[0]
        boxes.append(bq.reshape(b, 64, -1))
        clss.append(cq.reshape(b, 80, -1))
    box = np.concatenate(boxes, 2)
    cls = np.concatenate(clss, 2)
    b, _, n = box.shape

    bins = box.reshape(b, 4, 16, n).transpose(0, 2, 1, 3)
    y = bins - bins.max(axis=1, keepdims=True)
    e = h.exp_lut.apply_np(y)
    # reference: p = int64(y/sum * 127) in float64 (truncation toward 0;
    # e >= 0 so it equals the integer floor division)
    ssum = np.maximum(e.sum(axis=1, keepdims=True), 1)
    p = np.int64(e / ssum * 127)

    acc = np.einsum("brcn,r->bcn", p, np.int64(h.dfl_w_q).reshape(16))
    # (1,1,1,1) old-scale array: the broadcast promotes the (b,4,n) DFL
    # to 4D exactly like the reference (stage_6_full_quant.py:757-758)
    dfl_q4, dfl_r, dfl_s = requantize_np(
        acc, np.float64(h.dfl_acc_scale).reshape(1, 1, 1, 1),
        h.anchor_scale, 16, model.cfg.koeff_bits)
    out.update(p=p, cls=cls, shapes=shapes, dfl_q4=dfl_q4, dfl_r=dfl_r,
               dfl_s=dfl_s)
    return out


def decode_full_quant_np(model: QuantizedModel, env: Dict) -> np.ndarray:
    """Fully-quantized head in the golden int64/float64 semantics
    (reference stage_6_full_quant tail; see SURVEY.md §2.3.7-8). Returns
    (B, 84, N) with boxes in anchor-scale units and 16-bit sigmoid class
    units — the q_NMS input domain."""
    h = model.head
    it = head_intermediates_np(model, env)
    anchors, strides = _np_make_anchors(it["shapes"])
    anchors_q = np.round(anchors * h.anchor_scale)
    dbox = _np_dist2bbox(np.float64(it["dfl_q4"][0]),
                         anchors_q[None]) * strides
    cls_sig = h.cls_sigmoid_lut.apply_np(it["cls"])
    return np.concatenate((dbox, np.float64(cls_sig)), 1)
