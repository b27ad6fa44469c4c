"""Integer interpreter of the quantized network on torch tensors
(counterpart of alpha_yolo_quant_tpu/runtime/interpreter.py).

Both packages consume the same host-side numpy ``QuantizedModel``;
``device_plan`` carries its integers onto a torch device, so the two
runtimes compute the same function. Activations live in NHWC, int8, or
int16 on the wide edges (``edge_amax_int > 127``); public outputs are
NCHW like the JAX function's. Every conv runs through the Hopper kernel
wrappers (runtime/fused_ops.py, runtime/packed_conv.py): the kernels on a
CUDA device, their plain versions on the CPU.

Engines (``int_forward(engine=...)``), all bit-identical:
  fused   every conv on the implicit-GEMM kernels conv1x1/conv3x3 with
          the epilogue in registers, wide int16 inputs included
  pallas  every conv as two nibble-split partial convs (ops/nn.py
          conv2d_int_parts) and the postconv epilogue kernels, as the
          JAX ``pallas`` engine runs them
  packed  the narrow-channel region lane-packed in slabs, its convs on the
          banded packed_conv kernel (runtime/slabforward.py); the other
          convs as in ``fused``
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch

from alpha_yolo_quant_torch.models.graph import (
    ConcatNode, ConvNode, MaxPoolNode, ResidualAddNode, SplitNode,
    UpsampleNode,
)
from alpha_yolo_quant_torch.models.head import (  # noqa: F401 (re-export)
    STRIDES, decode_float, dequantize_heads, dist2bbox, head_conv_name,
    make_anchors,
)
from alpha_yolo_quant_torch.quantize.transform import QuantizedModel
from alpha_yolo_quant_torch.ops.intmath import requantize, requantize_small
from alpha_yolo_quant_torch.ops.lut import DeviceLut
from alpha_yolo_quant_torch.ops.nn import (
    conv2d_int_parts, maxpool2d, upsample_nearest,
)
from alpha_yolo_quant_torch.runtime import fused_ops
from alpha_yolo_quant_torch.runtime.ingest import StagedIngest
from alpha_yolo_quant_torch.runtime.slabforward import (
    SlabExec, build_slab_plan,
)
from alpha_yolo_quant_torch.utils.profiling import span

ENGINES = ("fused", "pallas", "packed")


def device_plan(model: QuantizedModel, device) -> Dict:
    """The model's integer constants as tensors on ``device``: per conv the
    wrapper entry (fused_ops.conv_entry), the scalar structural requants,
    the LUTs as tables, and the full-quant head constants. Runs the sigma
    probe once, which must find no fixups."""
    device = torch.device(device)
    qmax = model.cfg.qmax
    sig = DeviceLut(model.sig_lut, device)
    if not (sig.lo <= -qmax and sig.hi >= qmax):
        raise ValueError("sigmoid LUT domain must cover the clipped "
                         "requant range")
    corrections = fused_ops.sigma_corrections(sig)
    if corrections:
        raise RuntimeError(f"epilogue sigmoid differs from the table at "
                           f"{corrections}")
    plan: Dict = {"device": device, "sig_lut": sig, "convs": {},
                  "requants": {}}
    for name, c in model.convs.items():
        n = c.node
        plan["convs"][name] = fused_ops.conv_entry(
            c.w_q, c.b_q, n.stride, n.padding, n.silu, device,
            r1=c.r1, s1=c.s1, r2=c.r2, s2=c.s2)
    for key, r in model.requants.items():
        plan["requants"][key] = (int(r.rescale), int(r.shift))
    if model.head is not None:
        h = model.head

        def lv(d):
            return {k: torch.as_tensor(np.int64(v), device=device)
                    for k, v in d.items()}

        plan["head"] = {
            "box_r": lv(h.box_r), "box_s": lv(h.box_s),
            "cls_r": lv(h.cls_r), "cls_s": lv(h.cls_s),
            "exp_lut": DeviceLut(h.exp_lut, device),
            "cls_sig_lut": DeviceLut(h.cls_sigmoid_lut, device),
            "dfl_w": torch.as_tensor(np.int64(h.dfl_w_q).reshape(16),
                                     device=device),
        }
    return plan


@functools.lru_cache(maxsize=None)
def _u8_divisor(device: torch.device) -> torch.Tensor:
    """The 0-dim float32 255 that quantize_input divides uint8 pixels by,
    made once per device."""
    return torch.full((), 255.0, device=device)


def quantize_input(x: torch.Tensor, k: int,
                   per_image_amax: bool = False) -> torch.Tensor:
    """Image (NCHW f32 in [0, 1], or raw uint8 pixels) -> int8 K-bit
    values, rounding half to even.

    Default pins a=1 like the golden pipeline (reference
    utils/quant_matrix.py:70-72 start=True); per_image_amax re-derives a
    per image, the stage-8 runtime quirk (stage_8_torch.py:510 with
    start=False): s = qmax / a, a true division of two tensors as in the
    JAX function (``qmax / a`` on a tensor would be a reciprocal times
    qmax, and round(x * s) would then miss JAX's ties).

    uint8 is normalised here as u/255 in float32, dividing by a 0-dim
    tensor on x's device (``_u8_divisor``): IEEE division on the CPU and
    on CUDA, so the float32 values equal a host loader's u/255. (On CUDA,
    dividing by a Python float or a CPU scalar multiplies by its float32
    reciprocal, which differs from the quotient for 126 of the 256 pixel
    values.)"""
    if x.dtype == torch.uint8:
        x = x.to(torch.float32) / _u8_divisor(x.device)
    if k > 8:
        raise ValueError(f"k={k}: quantized inputs are carried as int8")
    qmax = 2 ** (k - 1) - 1
    if per_image_amax:
        a = torch.amax(torch.abs(x), dim=(1, 2, 3), keepdim=True)
        q = torch.clamp(x, -a, a) * (torch.full_like(a, float(qmax)) / a)
    else:
        q = torch.clamp(x, -1.0, 1.0) * float(qmax)
    return torch.round(q).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Per-pipeline options (counterpart of the JAX EngineOptions, whose
    TPU flavor fields bf16_s2, s2d and merge_siblings have no counterpart:
    the port's engines stand for those layouts).

    per_image_amax: quantize the input with a per-image amax instead of
    the calibrated a=1 pin, the stage-8 deployed-runtime quirk (reference
    stage_8_torch.py:510, quant_matrix start=False): the runtime
    re-derives the input scale per image but keeps the rescale
    coefficients computed from the calibration scale. Needed for
    detection-level parity with the reference's stage-8 runtimes; off for
    the stage-6/golden contract.

    The wrapper keeps the JAX call ``build_int_pipeline(options=...)``,
    so that the mAP evaluation, its only user, calls both pipelines the
    same way.
    """

    per_image_amax: bool = False


def _store_dtype(model: QuantizedModel, edge: str) -> torch.dtype:
    """int16 on the wide edges (|v| up to 3*qmax), int8 elsewhere."""
    return torch.int16 if model.edge_amax_int.get(edge, 0) > 127 \
        else torch.int8


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _check_engine(engine: str, keep_env: bool = False,
                  plain: bool = False) -> None:
    if engine not in ENGINES:
        raise ValueError(f"engine {engine!r}: one of {ENGINES}")
    if engine != "fused" and (keep_env or plain):
        raise ValueError(f"keep_env and plain run on the fused engine, "
                         f"not {engine!r}")


def slab_plan(model: QuantizedModel, plan: Dict):
    """The packed engine's SlabPlan, built once per device plan (a caller
    may set ``plan["slabplan"]`` to a build_slab_plan(allow=...) hybrid)."""
    sp = plan.get("slabplan")
    if sp is None:
        sp = plan["slabplan"] = build_slab_plan(model)
    return sp


def _pallas_conv(node, c: Dict, x: torch.Tensor, sig: DeviceLut,
                 qmax: int) -> torch.Tensor:
    """The pallas engine's conv: nibble-split partials, then the postconv
    epilogue kernel over the NHWC result (channel axis 3)."""
    hi, lo = conv2d_int_parts(x, c)
    if node.silu:
        return fused_ops.postconv_silu(hi, lo, c["b"], c["r1"], c["s1"],
                                       c["r2"], c["s2"], sig, qmax, axis=3)
    return fused_ops.postconv_plain(hi, lo, c["b"], axis=3)


def run_node(model: QuantizedModel, plan: Dict, idx: int,
             env: Dict[str, torch.Tensor], engine: str = "fused",
             plain: bool = False,
             extra: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Run graph node ``idx`` on the NHWC tensors of ``env`` and store its
    outputs there: the body of int_forward's node loop (the packed
    engine's slab nodes aside), also run by the height-banded forward of
    parallel/mesh.py on widened bands. ``extra``: where keep_env's
    intermediates go (None: not collected). The node runs inside its
    span (utils/profiling.SPANS): ``ayq.forward.conv.<name>`` for a conv
    layer, ``ayq.forward.<kind>`` for the others."""
    node = model.graph.nodes[idx]
    if isinstance(node, ConvNode):
        name, layer = "ayq.forward.conv.", node.name
    else:
        name, layer = _GLUE_SPANS[type(node)], ""
    with span(name, layer):
        _run_node(model, plan, idx, node, env, engine, plain, extra)


_GLUE_SPANS = {SplitNode: "ayq.forward.split",
               ResidualAddNode: "ayq.forward.add",
               ConcatNode: "ayq.forward.concat",
               MaxPoolNode: "ayq.forward.maxpool",
               UpsampleNode: "ayq.forward.upsample"}


def _run_node(model: QuantizedModel, plan: Dict, idx: int, node,
              env: Dict[str, torch.Tensor], engine: str, plain: bool,
              extra: Optional[Dict[str, torch.Tensor]]) -> None:
    qmax = model.cfg.qmax
    if isinstance(node, ConvNode):
        c = plan["convs"][node.name]
        x = env[node.src]
        if engine == "pallas":
            env[node.dst] = _pallas_conv(node, c, x, plan["sig_lut"], qmax)
            return
        conv = (fused_ops.conv_plain if plain
                else fused_ops.conv1x1 if node.kernel == 1
                else fused_ops.conv3x3)
        env[node.dst] = conv(x, c, plan["sig_lut"], qmax)
        if extra is not None and node.silu:
            acc = fused_ops.conv_acc_plain(x, c)
            extra[f"{node.name}:sigdom"] = _nchw(
                requantize(acc, c["r1"], c["s1"], qmax))
    elif isinstance(node, SplitNode):
        t = env[node.src]
        h = t.shape[3] // 2
        env[node.dst1] = t[..., :h].contiguous()
        env[node.dst2] = t[..., h:].contiguous()
    elif isinstance(node, ResidualAddNode):
        r, s = plan["requants"][(idx, node.src)]
        req = requantize_small(env[node.src], r, s, qmax)
        if extra is not None:
            extra[f"{node.label}:rescale"] = _nchw(req)
        out = req + env[node.base].to(torch.int32)
        bound = model.clip_after_residual.get(idx)
        if bound is not None:
            out = torch.clamp(out, -bound, bound)
        env[node.dst] = out.to(_store_dtype(model, node.dst))
    elif isinstance(node, ConcatNode):
        dt = _store_dtype(model, node.dst)
        parts = []
        for e in node.srcs:
            t = env[e]
            if (idx, e) in plan["requants"]:
                r, s = plan["requants"][(idx, e)]
                t = requantize_small(t, r, s, qmax)
                if extra is not None:
                    extra[f"{node.label}:{e}:requant"] = _nchw(t)
            parts.append(t.to(dt))
        env[node.dst] = torch.cat(parts, dim=3)
    elif isinstance(node, MaxPoolNode):
        env[node.dst] = maxpool2d(env[node.src], node.kernel,
                                  node.stride, node.padding, nhwc=True)
    elif isinstance(node, UpsampleNode):
        env[node.dst] = upsample_nearest(env[node.src], node.factor,
                                         nhwc=True)
    else:  # pragma: no cover
        raise TypeError(type(node))


def requant_heads(model: QuantizedModel, plan: Dict,
                  outs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The full-quant head's first requant of the six raw head edges: box
    -> int8, cls -> int16 (int_forward's head_requant)."""
    if model.head is None:
        raise ValueError("head_requant needs a full-quant model")
    hp = plan["head"]
    outs = dict(outs)
    for level in ("p3", "p4", "p5"):
        for kind, qmx, dt in (("box", 127, torch.int8),
                              ("cls", 2 ** 15 - 1, torch.int16)):
            role = f"{level}_{kind}"
            outs[role] = requantize(outs[role], hp[f"{kind}_r"][level],
                                    hp[f"{kind}_s"][level], qmx).to(dt)
    return outs


def int_forward(model: QuantizedModel, plan: Dict, x_q: torch.Tensor,
                keep_env: bool = False, head_requant: bool = False,
                plain: bool = False, engine: str = "fused",
                node_range=None, env_in=None,
                out_edges=None) -> Dict[str, torch.Tensor]:
    """Run the integer graph on NCHW int8 input. Returns the six head
    edges, NCHW: raw int32 accumulators, or with head_requant the
    full-quant head's first requant (box -> int8, cls -> int16).

    engine: "fused", "pallas" or "packed" (module docstring).

    plain=True runs every conv through the kernels' plain PyTorch version
    on whatever device the input is on: the reference path that a kernel
    run on the card is held against. It and keep_env run on the fused
    engine only.

    keep_env adds ``'__env__'``: every edge (NCHW) plus the golden
    oracle's intermediates ``<conv>:sigdom``, ``<label>:rescale`` and
    ``<label>:<edge>:requant``. The edges come from the same kernels as
    without it; the sigdom values are recomputed by the plain conv.

    Segmented execution (the pipeline-parallel seam, parallel/pipeline.py):
    node_range=(lo, hi) with env_in (the segment's live input edges, NCHW;
    x_q is ignored) and out_edges (the edge names to return, NCHW). The
    same node loop runs over the slice, so a chain of segments equals the
    whole-graph call bit for bit by construction; head_requant and the
    outputs' collection are skipped (the caller owns the seams). Segments
    run on the fused engine, with or without plain: the packed engine's
    slab plan indexes nodes absolutely."""
    segmented = node_range is not None
    if segmented or env_in is not None or out_edges is not None:
        # hard errors, not asserts: python -O strips asserts
        if not (segmented and env_in is not None and out_edges is not None):
            raise ValueError(
                "segmented execution needs node_range + env_in + out_edges")
        if engine != "fused" or keep_env:
            raise ValueError(
                "segments run the plain NCHW engines (no keep_env/nhwc/"
                "pallas)")
    _check_engine(engine, keep_env, plain)
    if segmented:
        env: Dict[str, torch.Tensor] = {
            e: t.permute(0, 2, 3, 1).contiguous() for e, t in env_in.items()}
        lo, hi = node_range
    else:
        env = {model.graph.input_edge: x_q.permute(0, 2, 3, 1).contiguous()}
        lo, hi = 0, len(model.graph.nodes)
    extra: Optional[Dict[str, torch.Tensor]] = {} if keep_env else None
    slabs = (SlabExec(slab_plan(model, plan), model, plan, env,
                      model.cfg.qmax)
             if engine == "packed" else None)
    for idx in range(lo, hi):
        if slabs is not None:
            pre = slabs.sp.pre_ops.get(idx)
            if pre:
                with span("ayq.forward.slab"):
                    slabs.run(pre)
            if idx in slabs.sp.nodes:
                with span("ayq.forward.slab"):
                    slabs.run(slabs.sp.node_ops.get(idx, ()))
                continue
        run_node(model, plan, idx, env, engine, plain, extra)

    if segmented:
        return {e: _nchw(env[e]).contiguous() for e in out_edges}
    if slabs is not None:
        with span("ayq.forward.slab"):
            slabs.run(slabs.sp.pre_ops.get(len(model.graph.nodes), ()))
    outs = {role: _nchw(env[e]).contiguous()
            for role, e in model.graph.outputs.items()}
    if head_requant:
        with span("ayq.forward.head_requant"):
            outs = requant_heads(model, plan, outs)
    if keep_env:
        outs["__env__"] = {**{k: _nchw(v) for k, v in env.items()}, **extra,
                           **{role: _nchw(env[e])
                              for role, e in model.graph.outputs.items()}}
    return outs


def _dfl_softmax_probs(bins: torch.Tensor, dim: int,
                       exp_lut: DeviceLut) -> torch.Tensor:
    """Quantized DFL softmax over the 16-bin axis: p = (127*e) // sum with
    a true integer floor (e >= 0, so it equals the reference's float64
    truncation)."""
    y = bins - torch.amax(bins, dim=dim, keepdim=True)
    e = exp_lut.apply(y).to(torch.int64)
    ssum = torch.clamp(e.sum(dim=dim, keepdim=True), min=1)
    return torch.div(127 * e, ssum, rounding_mode="floor")


def _dfl_requant(model: QuantizedModel, plan: Dict, p: torch.Tensor,
                 dim: int) -> torch.Tensor:
    """16-tap DFL dot (exact int64) + requant to the anchor scale."""
    shape = [1] * p.dim()
    shape[dim] = 16
    acc = (p * plan["head"]["dfl_w"].reshape(shape)).sum(dim=dim)
    h = model.head
    return requantize(acc, h.dfl_r, h.dfl_s, 2 ** 15 - 1)


def _conf_cid_packed(cq: torch.Tensor):
    """(max, argmax) over the class axis (dim 1) as one max of the packed
    key score*128 + (C-1-class): ties go to the lowest class."""
    c = cq.shape[1]
    rev = torch.arange(c - 1, -1, -1, dtype=torch.int64, device=cq.device)
    key = (cq.to(torch.int64) << 7) + rev.reshape((1, c) + (1,) *
                                                  (cq.dim() - 2))
    kmax = torch.amax(key, dim=1)
    return kmax >> 7, ((c - 1) - (kmax & 127)).to(torch.float32)


def _decode_serving_per_level(model: QuantizedModel, plan: Dict,
                              outs: Dict):
    """Serving decode of head_requant outputs, level by level. Returns
    (dbox (B,4,N) xywh in anchor-scale units, conf (B,N) f32 pre-sigmoid
    class ints, cid (B,N) f32), N in p3, p4, p5 row-major anchor order."""
    h = model.head
    dboxes, confs, cids = [], [], []
    for li, level in enumerate(("p3", "p4", "p5")):
        bq = outs[f"{level}_box"].to(torch.int64)       # (b,64,h,w)
        cq = outs[f"{level}_cls"]                        # (b,80,h,w)
        b, _, hh, ww = bq.shape
        p = _dfl_softmax_probs(bq.reshape(b, 4, 16, hh, ww), 2,
                               plan["head"]["exp_lut"])
        dfl_q = _dfl_requant(model, plan, p, 2)
        anchors_l, strides_l = make_anchors(
            [(hh, ww)], strides=STRIDES[li:li + 1], device=bq.device)
        anchors_ql = torch.round(anchors_l * h.anchor_scale)
        dboxes.append(dist2bbox(
            dfl_q.reshape(b, 4, hh * ww).to(torch.float32),
            anchors_ql[None]) * strides_l)
        conf_l, cid_l = _conf_cid_packed(cq)
        confs.append(conf_l.reshape(b, -1).to(torch.float32))
        cids.append(cid_l.reshape(b, -1))
    return torch.cat(dboxes, 2), torch.cat(confs, 1), torch.cat(cids, 1)


def decode_select_sparse(model: QuantizedModel, plan: Dict, outs: Dict,
                         *, pre_topk: int, conf_thres: float):
    """Serving decode fused with the q_NMS candidate selection, conf first
    (counterpart of the JAX function of the same name).

    The dense path decodes the boxes of all N anchors and then keeps the
    top ``pre_topk`` by class confidence. Confidence alone decides that
    cut, so this path ranks first, by the same packed key the dense select
    sorts (``conf_sort_key``: unique, so any descending order is the
    dense one), and runs the DFL softmax, the DFL requant, the anchors and
    dist2bbox only for the kept anchors, with the dense path's per-anchor
    arithmetic. Needs head_requant outputs (int8 box, int16 class edges)
    and N < 2^14 anchors. Returns (boxes_xyxy (B,m,4), conf (B,m),
    cid (B,m), valid (B,m)) in descending (conf, lowest-index-first)
    order: non_max_suppression(preselected=True)'s input."""
    from alpha_yolo_quant_torch.postprocess.nms import (
        conf_from_key, conf_sort_key, index_from_key, xywh2xyxy,
    )

    h = model.head
    confs, cids, boxes, shapes = [], [], [], []
    for level in ("p3", "p4", "p5"):
        cq = outs[f"{level}_cls"]                        # (b,80,h,w)
        b = cq.shape[0]
        conf_l, cid_l = _conf_cid_packed(cq)
        confs.append(conf_l.reshape(b, -1))
        cids.append(cid_l.reshape(b, -1))
        bq = outs[f"{level}_box"]                        # int8 (b,64,h,w)
        shapes.append((bq.shape[2], bq.shape[3]))
        boxes.append(bq.reshape(b, 64, -1))
    conf = torch.cat(confs, 1)
    cid = torch.cat(cids, 1)
    box_flat = torch.cat(boxes, 2)                       # (b,64,N) int8
    n = conf.shape[1]
    if n >= 1 << 14:
        raise ValueError(f"sparse select needs N < 2^14 anchors, got {n}")
    m = min(pre_topk, n)
    skey = torch.topk(conf_sort_key(conf, n), m, dim=1, sorted=True).values
    conf_s = conf_from_key(skey).to(torch.float32)
    idx = index_from_key(skey, n).to(torch.int64)        # (b,m)
    cid_s = torch.gather(cid, 1, idx)
    bins = torch.gather(box_flat, 2, idx[:, None, :].expand(-1, 64, -1))
    p = _dfl_softmax_probs(bins.to(torch.int64).reshape(-1, 4, 16, m), 2,
                           plan["head"]["exp_lut"])
    dfl_q = _dfl_requant(model, plan, p, 2)              # (b,4,m)
    anchors, strides = make_anchors(shapes, device=box_flat.device)
    anchors_q = torch.round(anchors * h.anchor_scale)    # (2,N)
    a_g = anchors_q.T[idx]                               # (b,m,2)
    s_g = strides[0][idx]                                # (b,m)
    dbox = dist2bbox(dfl_q.to(torch.float32),
                     a_g.transpose(1, 2)) * s_g[:, None, :]
    return (xywh2xyxy(dbox.transpose(1, 2)), conf_s, cid_s,
            conf_s > conf_thres)


def decode_full_quant(model: QuantizedModel, plan: Dict, outs: Dict,
                      sigmoid_cls: bool = True, reduce_cls: bool = False,
                      pre_requantized: bool = False):
    """Fully-quantized head: 8-bit box requant, LUT-exponent softmax,
    quantized DFL, quantized anchors, 16-bit LUT class sigmoid. Returns
    (B, 84, N) in anchor-scale box units and 16-bit sigmoid class units;
    with reduce_cls (sigmoid deferred) the tuple (boxes_xywh (B,4,N),
    conf (B,N), cls (B,N)) instead."""
    if reduce_cls and sigmoid_cls:
        raise ValueError("reduce_cls defers the sigmoid to NMS")
    if pre_requantized and reduce_cls:
        return _decode_serving_per_level(model, plan, outs)
    h = model.head
    hp = plan["head"]
    boxes, clss, shapes = [], [], []
    for level in ("p3", "p4", "p5"):
        bq = outs[f"{level}_box"]
        cq = outs[f"{level}_cls"]
        shapes.append((bq.shape[2], bq.shape[3]))
        if not pre_requantized:
            bq = requantize(bq, hp["box_r"][level], hp["box_s"][level], 127)
            cq = requantize(cq, hp["cls_r"][level], hp["cls_s"][level],
                            2 ** 15 - 1)
        b = bq.shape[0]
        boxes.append(bq.to(torch.int64).reshape(b, 64, -1))
        clss.append(cq.to(torch.int64).reshape(b, 80, -1))
    box = torch.cat(boxes, 2)
    cls = torch.cat(clss, 2)
    b, _, n = box.shape
    p = _dfl_softmax_probs(box.reshape(b, 4, 16, n), 2, hp["exp_lut"])
    dfl_q = _dfl_requant(model, plan, p, 2)
    anchors, strides = make_anchors(shapes, device=box.device)
    anchors_q = torch.round(anchors * h.anchor_scale)
    dbox = dist2bbox(dfl_q.to(torch.float32), anchors_q[None]) * strides
    if reduce_cls:
        conf_i, cid = _conf_cid_packed(cls)
        return dbox, conf_i.to(torch.float32), cid
    if sigmoid_cls:
        cls = hp["cls_sig_lut"].apply(cls)
    return torch.cat((dbox, cls.to(torch.float32)), 1)


def cls_int_conf_threshold(model: QuantizedModel,
                           conf_thres_int: int = 8192) -> float:
    """Smallest requantized class score whose 16-bit sigmoid exceeds the
    integer threshold, minus 0.5: the pre-sigmoid form of
    ``conf > conf_thres_int`` (the sigmoid is monotone)."""
    lut = model.head.cls_sigmoid_lut
    above = np.nonzero(lut.values > conf_thres_int)[0]
    if len(above) == 0:
        return float(lut.hi) + 0.5
    return float(above[0] + lut.lo) - 0.5


def eval_nms_params(model: QuantizedModel, conf_thres: float):
    """NmsParams for the mAP protocol at a FLOAT confidence threshold.

    The reference's mAP runs use conf 1e-8 (stage_8_torch.py:147) while
    its serving demo uses 0.25; the full-quant path expresses the same cut
    in 16-bit sigmoid ints (8192 = round(0.25 * 32767),
    utils/bbox_cls_functions.py:195-250). This maps a float threshold onto
    whichever domain the model's NMS runs in; build_int_pipeline then
    converts quantized params to the deferred-sigmoid pre-sigmoid domain."""
    from alpha_yolo_quant_torch.postprocess.nms import (
        NmsParams, q_nms_params,
    )

    if model.cfg.full_quant:
        return q_nms_params(model.head.anchor_scale,
                            conf_thres_int=int(round(conf_thres * 32767)))
    return NmsParams(conf_thres=conf_thres, pre_topk=1000)


def build_int_pipeline(model: QuantizedModel, device="cuda",
                       dfl_w_float=None, with_nms: bool = True,
                       nms_params=None,
                       pad_batch_to: Optional[int] = None,
                       options: Optional[EngineOptions] = None,
                       coalesce_requests: Optional[int] = None,
                       plain: bool = False, engine: str = "fused",
                       sparse_select: bool = False, forward=None):
    """Return ``(fn, plan)``: fn maps images (NCHW float32 in [0, 1] or
    uint8, numpy or torch) to detections ``(det (B,300,6), n_det (B,))``
    on ``device``.

    Full quant: integer head, deferred-sigmoid q_NMS. Partial quant: the
    float head (dequantized accumulators) needs ``dfl_w_float``.
    nms_params: None for the serving defaults; quantized params for a
    full-quant model carry conf_thres in the 16-bit post-sigmoid domain
    (q_nms_params, eval_nms_params) and are moved to the pre-sigmoid
    domain here, keeping the deferred sigmoid.
    pad_batch_to: pad the quantized batch with zero images up to this
    width for the conv stack and slice back (per-image results are batch
    independent). options: EngineOptions (per_image_amax).
    coalesce_requests=N: fn takes N request arrays, quantizes each, runs
    one forward over their concatenation and returns one result per
    request. plain: convs through their plain versions; engine: "fused",
    "pallas" or "packed" (see int_forward).
    sparse_select: decode only the top pre_topk anchors by class score
    (decode_select_sparse), where the pipeline is eligible: full quant with
    NMS, quantized NMS params with a pre_topk cut and the deferred
    sigmoid, and N < 2^14 anchors (JAX's rule); elsewhere the dense decode
    runs. Bit-identical to the dense decode and select either way.
    forward: run forward(plan, x_q) in place of int_forward; it returns the
    six head edges as int_forward(head_requant=<full quant>) does. The
    sharded forwards of parallel/mesh.py come in here, so that they share
    the rest of the pipeline.

    Host images reach a CUDA device through the pipeline's own ring of
    pinned chunks (runtime/ingest.py StagedIngest); images already on a
    device, and every call on the CPU, go through torch.as_tensor."""
    from alpha_yolo_quant_torch.postprocess.nms import (
        NmsParams, non_max_suppression, q_nms_params,
    )
    from alpha_yolo_quant_torch.serving import split_by_sizes

    _check_engine(engine, plain=plain)
    if options is None:
        options = EngineOptions()
    device = torch.device(device)
    plan = device_plan(model, device)
    k = model.cfg.k
    full = model.cfg.full_quant
    score_map = None
    if nms_params is None:
        if full:
            # rank raw int class scores; sigmoid only the kept rows
            nms_params = dataclasses.replace(
                q_nms_params(model.head.anchor_scale),
                conf_thres=cls_int_conf_threshold(model))
            score_map = plan["head"]["cls_sig_lut"].apply
        else:
            nms_params = NmsParams(conf_thres=0.25)
    elif full and nms_params.quantized:
        # the sigmoid is monotone: the post-sigmoid cut conf > t is the
        # pre-sigmoid cut through the LUT
        nms_params = dataclasses.replace(
            nms_params,
            conf_thres=cls_int_conf_threshold(
                model, int(nms_params.conf_thres)))
        score_map = plan["head"]["cls_sig_lut"].apply
    if not full:
        if dfl_w_float is None:
            raise ValueError("partial-quant pipeline needs dfl_w_float")
        dfl_w = torch.as_tensor(np.asarray(dfl_w_float), dtype=torch.float32,
                                device=device)

    n_anchors = sum((model.cfg.image_size // st) ** 2 for st in STRIDES)
    use_sparse = bool(sparse_select and full and with_nms
                      and score_map is not None and nms_params.quantized
                      and nms_params.pre_topk and n_anchors < (1 << 14))

    def _decode(outs):
        if use_sparse:
            return decode_select_sparse(
                model, plan, outs,
                pre_topk=min(nms_params.pre_topk, nms_params.max_nms),
                conf_thres=nms_params.conf_thres)
        if full:
            return decode_full_quant(model, plan, outs,
                                     sigmoid_cls=score_map is None,
                                     reduce_cls=(score_map is not None
                                                 and with_nms),
                                     pre_requantized=True)
        return decode_float(dequantize_heads(model, outs), dfl_w)

    def _post(outs):
        with span("ayq.decode"):
            preds = _decode(outs)
        if use_sparse:
            return non_max_suppression(preds, nms_params,
                                       score_map=score_map, preselected=True)
        if with_nms:
            return non_max_suppression(preds, nms_params,
                                       score_map=score_map)
        return preds

    def _quantized_run(x_q, b):
        padded = pad_batch_to is not None and b < pad_batch_to
        with span("ayq.forward"):
            if padded:
                x_q = torch.cat((x_q, x_q.new_zeros((pad_batch_to - b,)
                                                    + x_q.shape[1:])), 0)
            outs = (forward(plan, x_q) if forward is not None else
                    int_forward(model, plan, x_q, head_requant=full,
                                plain=plain, engine=engine))
            if padded:
                outs = {name: t[:b] for name, t in outs.items()}
        return _post(outs)

    ingest = StagedIngest(device)

    def _quant(images):
        with span("ayq.ingest"):
            x = ingest(images)
        with span("ayq.quantize"):
            return quantize_input(x, k, per_image_amax=options.per_image_amax)

    if coalesce_requests is not None:
        n_req = int(coalesce_requests)

        def fn(*requests):
            if len(requests) != n_req:
                raise ValueError(f"expected {n_req} requests, "
                                 f"got {len(requests)}")
            with span("ayq"):
                sizes = [r.shape[0] for r in requests]
                x_q = torch.cat([_quant(r) for r in requests], 0)
                return split_by_sizes(_quantized_run(x_q, sum(sizes)), sizes)
    else:
        def fn(images):
            with span("ayq"):
                return _quantized_run(_quant(images), images.shape[0])

    return fn, plan
