"""Batched NMS, float and quantized (q_NMS) (counterpart of
alpha_yolo_quant_tpu/postprocess/nms.py).

Same candidate selection, suppress predicate (float32, same operation
order), greedy keep set, max_det truncation and row compaction as the JAX
module. The keep mask is computed by Jacobi iteration over the whole
(M, M) suppress matrix of the score-sorted candidates instead of the TPU's
blocked scan: entry i only depends on entries before it, so after t sweeps
the first t entries are final and the unique fixpoint is the
sequential-greedy keep set.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class NmsParams:
    """NMS parameters. Float mode: scores in [0, 1], boxes in pixels.
    Quantized mode: boxes in anchor-scale units, scores in 16-bit sigmoid
    (or pre-sigmoid requantized) integer units, ``plus_one`` the +1 area
    term in those units; boxes and scores are divided by ``box_scale`` /
    ``score_scale`` on the way out.

    agnostic: suppress across classes (no per-class box offset).
    trunc_boxes: truncate the xyxy candidate boxes toward zero before NMS,
    the deployed stage-8 runtime's quirk (reference
    stage_8_torch_full_quant.py:316 ``.to(torch.int)``); its numpy twin
    (utils/bbox_cls_functions.py:209) does not, and that is the default.
    """

    conf_thres: float = 0.25
    iou_thres: float = 0.45
    max_det: int = 300
    max_nms: int = 30000
    max_wh: float = 7680.0
    agnostic: bool = False
    # keep only the top-k scores before NMS (None = all candidates); the
    # reference q_NMS truncates to 1000
    pre_topk: int = None  # type: ignore[assignment]
    quantized: bool = False
    box_scale: float = 1.0
    score_scale: float = 1.0
    plus_one: float = 1.0
    trunc_boxes: bool = False


def quantized_iou_multiplier(iou_thres: float) -> float:
    """The q_NMS intersection multiplier, round(1/iou_thres, 2) (2.22 at
    the reference's 0.45)."""
    return round(1.0 / float(iou_thres), 2)


def q_nms_params(anchor_scale: float, iou_thres: float = 0.45,
                 conf_thres_int: int = 8192,
                 score_scale: float = 32767.0) -> NmsParams:
    """The q_NMS parameter set derived from the anchor scale."""
    return NmsParams(conf_thres=float(conf_thres_int), iou_thres=iou_thres,
                     quantized=True, box_scale=float(anchor_scale),
                     score_scale=score_scale, pre_topk=1000,
                     plus_one=float(int(round(anchor_scale))))


def conf_sort_key(conf: torch.Tensor, n: int) -> torch.Tensor:
    """Packed selection key ``(conf + 2^15) << 14 | (n - 1 - index)`` over
    the last axis: a descending sort gives descending score,
    lowest-index-first. Needs n <= 2^14 and |conf| < 2^15."""
    idx = torch.arange(n, dtype=torch.int32, device=conf.device)
    return ((conf.to(torch.int32) + (1 << 15)) << 14) | (n - 1 - idx)


def conf_from_key(skey: torch.Tensor) -> torch.Tensor:
    return (skey >> 14) - (1 << 15)


def index_from_key(skey: torch.Tensor, n: int) -> torch.Tensor:
    return (n - 1) - (skey & ((1 << 14) - 1))


def xywh2xyxy(x: torch.Tensor) -> torch.Tensor:
    dw = x[..., 2] / 2
    dh = x[..., 3] / 2
    return torch.stack((x[..., 0] - dw, x[..., 1] - dh,
                        x[..., 0] + dw, x[..., 1] + dh), dim=-1)


def _suppress_matrix(boxes, areas, iou_thres, plus_one, quantized):
    """(..., M, M) bool: S[j, i] = candidate j suppresses candidate i by
    the predicate of the JAX _suppress_slice, in float32 and the same
    operation order (quantized: m*inter > a_i + a_j - m*inter with
    m = round(1/iou_thres, 2))."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    xx1 = torch.maximum(x1[..., :, None], x1[..., None, :])
    yy1 = torch.maximum(y1[..., :, None], y1[..., None, :])
    xx2 = torch.minimum(x2[..., :, None], x2[..., None, :])
    yy2 = torch.minimum(y2[..., :, None], y2[..., None, :])
    w = torch.clamp(xx2 - xx1 + plus_one, min=0.0)
    h = torch.clamp(yy2 - yy1 + plus_one, min=0.0)
    inter = w * h
    asum = areas[..., :, None] + areas[..., None, :]
    if quantized:
        t = inter * torch.tensor(quantized_iou_multiplier(iou_thres),
                                 dtype=torch.float32, device=boxes.device)
        return t > asum - t
    return inter / (asum - inter) > iou_thres


def greedy_keep_sorted(boxes, valid, iou_thres, max_det, plus_one,
                       quantized):
    """Sequential-greedy keep mask over candidates already in descending
    score order. boxes (..., M, 4) xyxy (class-offset), valid (..., M).
    Returns (..., M) bool with at most max_det True (the first kept
    ones in score order)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    areas = (x2 - x1 + plus_one) * (y2 - y1 + plus_one)
    m = boxes.shape[-2]
    sup = _suppress_matrix(boxes, areas, iou_thres, plus_one, quantized)
    earlier = torch.ones(m, m, dtype=torch.bool,
                         device=boxes.device).triu(1)        # j < i
    s = (sup & earlier).to(torch.float32)
    keep = valid
    while True:   # at most M + 1 sweeps; dense clusters need more
        killed = torch.matmul(keep.to(torch.float32).unsqueeze(-2),
                              s).squeeze(-2) > 0.5
        nxt = valid & ~killed
        if torch.equal(nxt, keep):
            break
        keep = nxt
    within = torch.cumsum(keep.to(torch.int32), dim=-1) <= max_det
    return keep & within


def _greedy_nms_mask(boxes, scores, valid, iou_thres, max_det, plus_one,
                     quantized):
    """Single-image keep mask in the caller's candidate order (the JAX
    function's signature): sorts by score (stable, valid first), then
    greedy_keep_sorted."""
    neg_inf = torch.tensor(float("-inf"), device=scores.device)
    perm = torch.sort(-torch.where(valid, scores, neg_inf),
                      stable=True).indices
    keep_s = greedy_keep_sorted(boxes[perm], valid[perm], iou_thres,
                                max_det, plus_one, quantized)
    keep = torch.zeros_like(keep_s)
    keep[perm] = keep_s
    return keep


def _select_candidates(pred, max_nms, conf_thres, pre_topk=None,
                       int_scores=False):
    """Batched candidate selection. pred: (B, 84, N) plane or the
    pre-reduced (boxes_xywh (B,4,N), conf (B,N), cls (B,N)) tuple.
    Returns score-sorted (boxes_xyxy (B,M,4), conf (B,M), cls (B,M),
    valid (B,M)) with invalid candidates at the end."""
    if isinstance(pred, tuple):
        bxywh, conf, cls = pred
        box = xywh2xyxy(bxywh.transpose(1, 2))
    else:
        box = xywh2xyxy(pred[:, :4].transpose(1, 2))
        conf, cls = torch.max(pred[:, 4:], dim=1)
        cls = cls.to(torch.float32)
    n = conf.shape[1]
    m = min(pre_topk or max_nms, max_nms, n)
    if int_scores and n <= (1 << 14):
        # packed unique int key: one sort gives descending score,
        # lowest-index-first order
        key = conf_sort_key(conf, n)
        skey, idx = torch.sort(key, dim=1, descending=True)
        skey, idx = skey[:, :m], idx[:, :m]
        conf_s = conf_from_key(skey).to(conf.dtype)
        return (torch.gather(box, 1, idx[..., None].expand(-1, -1, 4)),
                conf_s, torch.gather(cls, 1, idx), conf_s > conf_thres)
    valid = conf > conf_thres
    neg_inf = torch.tensor(float("-inf"), device=conf.device)
    idx = torch.sort(-torch.where(valid, conf, neg_inf), dim=1,
                     stable=True).indices[:, :m]
    return (torch.gather(box, 1, idx[..., None].expand(-1, -1, 4)),
            torch.gather(conf, 1, idx), torch.gather(cls, 1, idx),
            torch.gather(valid, 1, idx))


def non_max_suppression(preds, params: NmsParams = NmsParams(),
                        score_map=None):
    """Batched NMS. preds: (B, 4+nc, N) xywh + class scores, or the
    pre-reduced (boxes_xywh (B,4,N), conf (B,N), cls (B,N)) tuple.
    score_map: optional monotone map applied to the kept rows' scores
    (the serving path's deferred 16-bit sigmoid).

    Returns (det (B, max_det, 6) float32 rows [x1,y1,x2,y2,conf,cls],
    descaled for q_NMS, zero past n_det; n_det (B,) int32)."""
    p = params
    boxes, conf, cls, valid = _select_candidates(
        preds, p.max_nms, p.conf_thres, p.pre_topk, int_scores=p.quantized)
    if p.trunc_boxes:
        boxes = torch.trunc(boxes)
    offset = cls * (0.0 if p.agnostic else p.max_wh)
    keep = greedy_keep_sorted(boxes + offset[..., None], valid, p.iou_thres,
                              p.max_det, p.plus_one, p.quantized)
    b, m = conf.shape
    # kept rows to the front in score order (stable sort of the mask)
    order = torch.sort((~keep).to(torch.int8), dim=1, stable=True).indices
    n_out = min(m, p.max_det)
    order = order[:, :n_out]
    kept = torch.gather(keep, 1, order)
    bx = torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4))
    conf_k = torch.gather(conf, 1, order)
    if score_map is not None:
        conf_k = torch.where(kept, score_map(conf_k.to(torch.int64)),
                             torch.zeros((), dtype=torch.int32,
                                         device=conf.device))
    # descale by the float32 reciprocal: the compiled JAX pipeline's
    # arithmetic (XLA turns x / const into x * (1 / const)); eager JAX
    # divides and can differ from it in the last bit
    rows = torch.cat((bx * _recip(p.box_scale),
                      (conf_k * _recip(p.score_scale))[..., None],
                      torch.gather(cls, 1, order)[..., None]), dim=2)
    rows = torch.where(kept[..., None], rows,
                       torch.zeros((), device=rows.device))
    det = torch.zeros((b, p.max_det, 6), dtype=torch.float32,
                      device=rows.device)
    det[:, :n_out] = rows
    return det, keep.sum(dim=1, dtype=torch.int32)


def _recip(scale: float) -> torch.Tensor:
    one = torch.tensor(1.0, dtype=torch.float32)
    return one / torch.tensor(scale, dtype=torch.float32)


def clip_boxes(boxes, hw):
    """Clip xyxy boxes to (h, w)."""
    h, w = hw
    return torch.stack((boxes[..., 0].clamp(0, w), boxes[..., 1].clamp(0, h),
                        boxes[..., 2].clamp(0, w), boxes[..., 3].clamp(0, h)),
                       dim=-1)


def scale_boxes(model_hw, boxes, orig_hw):
    """Map boxes from the model's letterboxed frame back to the original
    image."""
    gain = min(model_hw[0] / orig_hw[0], model_hw[1] / orig_hw[1])
    pad_x = round((model_hw[1] - orig_hw[1] * gain) / 2 - 0.1)
    pad_y = round((model_hw[0] - orig_hw[0] * gain) / 2 - 0.1)
    shifted = torch.stack((boxes[..., 0] - pad_x, boxes[..., 1] - pad_y,
                           boxes[..., 2] - pad_x, boxes[..., 3] - pad_y),
                          dim=-1)
    return clip_boxes(shifted / gain, orig_hw)
