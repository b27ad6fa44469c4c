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
    AttentionNode, ConcatNode, ConvNode, MaxPoolNode, ResidualAddNode,
    SplitNode, UpsampleNode,
)
from alpha_yolo_quant_torch.models.head import level_stride
from alpha_yolo_quant_torch.quantize.primitives import requantize_np, scale_for
from alpha_yolo_quant_torch.quantize.transform import AttnPlan, QuantizedModel


def conv2d_int64(x: np.ndarray, w: np.ndarray, stride: int,
                 padding: int, groups: int = 1) -> np.ndarray:
    """Integer conv via padded sliding windows (int64 exact); groups 1 or
    the channel count (depthwise, w of shape (C, 1, kh, kw))."""
    if padding:
        x = np.pad(x, ((0, 0), (0, 0), (padding, padding),
                       (padding, padding)))
    kh, kw = w.shape[2], w.shape[3]
    win = np.lib.stride_tricks.sliding_window_view(x, (kh, kw), axis=(2, 3))
    win = win[:, :, ::stride, ::stride]                    # (N,C,H',W',kh,kw)
    if groups > 1:
        if groups != x.shape[1] or w.shape[:2] != (groups, 1):
            raise ValueError("grouped convs are depthwise only")
        return np.einsum("nchwij,cij->nchw", win.astype(np.int64),
                         w[:, 0].astype(np.int64), optimize=True)
    return np.einsum("nchwij,ocij->nohw", win.astype(np.int64),
                     w.astype(np.int64), optimize=True)


def attention_np(a: AttnPlan, qkv: np.ndarray, k: int,
                 koeff_bits: int = 8):
    """The attention's integer contract on the int8 qkv edge (B, C, H, W),
    per image and head over the N = H * W pixels:

        L   = q^T k                       exact (|L| <= key_dim * 127^2)
        Lq  = requant(L, logit_old -> logit_scale), 8 bits
        e   = exp_lut[Lq - rowmax(Lq)]    the DFL's softmax core
        A   = sum_m e[n, m] v[d, m]       exact (<= N * 127^2)
        S   = sum_m e[n, m]               (>= 127: the row's max gives it)
        out = requant(floor(A / S), in_scale -> out_scale), K bits

    normalised after the product, so a flat softmax keeps its sum (a
    7- or 8-bit probability of a row over 400 pixels would be 0). Returns
    (out, v), (B, heads * head_dim, H, W) each, channel h * head_dim +
    d."""
    n = a.node
    b, _, hh, ww = qkv.shape
    t = np.int64(qkv).reshape(b, n.heads, 2 * n.key_dim + n.head_dim, -1)
    q, kk = t[:, :, :n.key_dim], t[:, :, n.key_dim:2 * n.key_dim]
    v = t[:, :, 2 * n.key_dim:]
    logits = np.einsum("bhdn,bhdm->bhnm", q, kk)
    lq, _, _ = requantize_np(logits, a.logit_old, a.logit_scale, 8,
                             koeff_bits)
    e = a.exp_lut.apply_np(lq - lq.max(axis=3, keepdims=True))
    acc = np.einsum("bhnm,bhdm->bhdn", e, v)
    out = acc // e.sum(axis=3)[:, :, None, :]
    out, _, _ = requantize_np(out, a.in_scale, a.out_scale, k, koeff_bits)
    shape = (b, n.heads * n.head_dim, hh, ww)
    return out.reshape(shape), v.reshape(shape)


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
                               node.padding, node.groups)
            acc = acc + np.int64(c.b_q).reshape(1, -1, 1, 1)
            if node.requant_out:
                env[node.dst], _, _ = requantize_np(
                    acc, c.acc_scale, c.out_scale, k, cfg.koeff_bits)
            elif node.silu:
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
        elif isinstance(node, AttentionNode):
            env[node.dst], env[node.v_dst] = attention_np(
                model.attns[node.name], env[node.src], k, cfg.koeff_bits)

    for role, e in model.graph.outputs.items():
        env[role] = env[e]
    return env


def _np_make_anchors(shapes, strides=None, offset=0.5):
    if strides is None:
        strides = [level_stride(f"p{3 + i}") for i in range(len(shapes))]
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
    stage_6.py:598-634): dequantize the head accumulators, float softmax +
    DFL + sigmoid. Returns (B, 84, N)."""
    g = model.graph
    deq = {}
    for role in g.outputs:
        acc = np.float64(env[role])
        deq[role] = acc / model.convs[g.head_conv(role)].acc_scale
    boxes = [deq[f"{lv}_box"] for lv in g.levels]
    clss = [deq[f"{lv}_cls"] for lv in g.levels]
    shapes = [(t.shape[2], t.shape[3]) for t in boxes]
    anchors, strides = _np_make_anchors(
        shapes, [level_stride(lv) for lv in g.levels])
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
    anchor scale (4D via the reference's (1,1,1,1)-scale broadcast);
    levels in the graph's order."""
    g = model.graph
    h = model.head
    out: Dict = {"levels": {}}
    boxes, clss, shapes = [], [], []
    for level in g.levels:
        bacc = np.int64(env[f"{level}_box"])
        cacc = np.int64(env[f"{level}_cls"])
        shapes.append((bacc.shape[2], bacc.shape[3]))
        up = model.convs[g.head_conv(f"{level}_box")]
        dn = model.convs[g.head_conv(f"{level}_cls")]
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
    anchors, strides = _np_make_anchors(
        it["shapes"], [level_stride(lv) for lv in model.graph.levels])
    anchors_q = np.round(anchors * h.anchor_scale)
    dbox = _np_dist2bbox(np.float64(it["dfl_q4"][0]),
                         anchors_q[None]) * strides
    cls_sig = h.cls_sigmoid_lut.apply_np(it["cls"])
    return np.concatenate((dbox, np.float64(cls_sig)), 1)
