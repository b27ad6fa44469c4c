"""Detect-head decode: anchors, dist2bbox, float DFL decode, head naming
(counterpart of alpha_yolo_quant_tpu/models/head.py and the head helpers
of its runtime/interpreter.py)."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

STRIDES = (8, 16, 32)
GRID_CELL_OFFSET = 0.5
REG_MAX = 16
NUM_CLASSES = 80


def make_anchors(shapes: List[Tuple[int, int]], strides=STRIDES,
                 device=None):
    """Anchor centers (2, N) + per-anchor stride (1, N), float32."""
    points, strs = [], []
    for (h, w), s in zip(shapes, strides):
        sx = (torch.arange(w, dtype=torch.float32, device=device)
              + GRID_CELL_OFFSET)
        sy = (torch.arange(h, dtype=torch.float32, device=device)
              + GRID_CELL_OFFSET)
        gy, gx = torch.meshgrid(sy, sx, indexing="ij")
        points.append(torch.stack((gx.reshape(-1), gy.reshape(-1)), 0))
        strs.append(torch.full((1, h * w), float(s), dtype=torch.float32,
                               device=device))
    return torch.cat(points, 1), torch.cat(strs, 1)


def dist2bbox(distance, anchor_points):
    """ltrb distances -> xywh boxes; dim 1 layout (B,4,N)."""
    lt, rb = torch.split(distance, 2, dim=1)
    x1y1 = anchor_points - lt
    x2y2 = anchor_points + rb
    return torch.cat(((x1y1 + x2y2) / 2, x2y2 - x1y1), 1)


def decode_float(outputs: Dict[str, torch.Tensor], dfl_w) -> torch.Tensor:
    """The six float head maps -> (B, 4+80, N): softmax over the 16 DFL
    bins, expectation under the DFL weights, dist2bbox * strides, class
    sigmoid."""
    boxes = [outputs[f"{lv}_box"] for lv in ("p3", "p4", "p5")]
    clss = [outputs[f"{lv}_cls"] for lv in ("p3", "p4", "p5")]
    b = boxes[0].shape[0]
    dev = boxes[0].device
    anchors, strides = make_anchors([(t.shape[2], t.shape[3])
                                     for t in boxes], device=dev)
    box = torch.cat([t.reshape(b, 4 * REG_MAX, -1) for t in boxes], 2)
    n = box.shape[2]
    probs = torch.softmax(box.reshape(b, 4, REG_MAX, n), dim=2)
    w = torch.as_tensor(dfl_w, dtype=torch.float32, device=dev)
    dfl = torch.einsum("bcrn,r->bcn", probs, w.reshape(REG_MAX))
    dbox = dist2bbox(dfl, anchors[None]) * strides
    cls = torch.sigmoid(torch.cat([t.reshape(b, NUM_CLASSES, -1)
                                   for t in clss], 2))
    return torch.cat((dbox, cls), 1)


def head_conv_name(role: str) -> str:
    return {"p3_box": "x_result_5_up_2", "p3_cls": "x_result_5_down_2",
            "p4_box": "x_result_6_up_2", "p4_cls": "x_result_6_down_2",
            "p5_box": "x_up_2", "p5_cls": "x_down_2"}[role]


def dequantize_heads(model, outs: Dict) -> Dict:
    """Raw int32 head accumulators -> float32 by each conv's acc scale."""
    deq = {}
    for role in model.graph.outputs:
        t = outs[role]
        scale = torch.as_tensor(model.convs[head_conv_name(role)].acc_scale,
                                dtype=torch.float32, device=t.device)
        deq[role] = t.to(torch.float32) / scale
    return deq
