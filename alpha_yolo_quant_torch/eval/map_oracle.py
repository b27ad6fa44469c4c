"""Deliberately-slow differential oracle for the mAP metric.

The BASELINE accuracy gate (<=0.5 mAP50-95 drop) is defined in terms of
the external ``map_boxes.mean_average_precision_for_boxes`` package
(reference stage_3.py:51-59 / stage_4.py:996-1004). That package cannot
be installed in this environment (zero egress), so this module is an
independent, loop-for-loop transcription of its published algorithm —
ZFTurbo's Mean-Average-Precision-for-Boxes, itself keras-retinanet's
``evaluate()`` — written from the algorithm's semantics, to fuzz the
vectorized ``eval.metrics`` implementation against
(tests/test_torch_eval.py holds the port's copy to it and to the JAX
package's).

Semantic commitments transcribed (each one is load-bearing and each was
a potential silent divergence for the vectorized implementation):

  1. Classes are the SORTED unique labels of the annotation rows; every
     class present in the annotations contributes to the mean (classes
     appearing only in detections are ignored).
  2. The per-image loop iterates the sorted unique annotation image ids
     ONLY: detections on images with no annotation rows at all are
     skipped entirely — they are NOT false positives.
  3. Within an image, detections are matched in INPUT ROW ORDER (not
     confidence order — keras-retinanet's detections arrive pre-sorted
     so its greedy loop never needed to sort); each detection claims
     only its argmax-IoU ground truth (first index on ties), becomes a
     TP iff that overlap >= threshold and the ground truth is
     unclaimed, else an FP — it never falls back to its second-best.
  4. Confidences are cast to float32 on load (get_detections), and the
     global PR curve orders the per-(image, row) TP/FP sequence by
     ``np.argsort(-scores)`` — quicksort, so tied scores keep that exact
     (deterministic) permutation, which both implementations reproduce
     by calling the identical numpy routine on the identical array.
  5. Overlap: iw/ih guarded ``> 0`` (degenerate or disjoint boxes give
     exactly 0), union = det_area + ann_area - intersection with no
     epsilon — an inverted box can legitimately produce a negative or
     infinite overlap and both implementations follow suit.
  6. precision = tp / max(tp + fp, float64 eps); AP is all-point
     interpolation over [0, recall..., 1] / [0, precision..., 0].
  7. The mean is the plain python-order sum over the sorted class dict.

Row format note: map_boxes takes [ImageID, LabelName, XMin, XMax, YMin,
YMax] (x1, x2, y1, y2); this repo's rows are [image_id, label, x1, y1,
x2, y2]. The column permutation is applied consistently to annotations
and detections, and every overlap/area term pairs the same coordinates,
so the metric value is identical (the reference feeds its own
consistently-permuted frames the same way).

Counterpart of alpha_yolo_quant_tpu/eval/map_oracle.py, numpy logic unchanged;
both packages write the same bytes and read each other's files.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _compute_overlap_row(det: np.ndarray, anns: np.ndarray) -> np.ndarray:
    """One detection (4,) against (M,4) annotations, xyxy float64 —
    the scalar transcription of map_boxes' compute_overlap loop."""
    m_count = anns.shape[0]
    out = np.zeros((m_count,), np.float64)
    det_area = (det[2] - det[0]) * (det[3] - det[1])
    for m in range(m_count):
        iw = min(det[2], anns[m, 2]) - max(det[0], anns[m, 0])
        if iw > 0:
            ih = min(det[3], anns[m, 3]) - max(det[1], anns[m, 1])
            if ih > 0:
                ua = det_area + (anns[m, 2] - anns[m, 0]) * (
                    anns[m, 3] - anns[m, 1]) - iw * ih
                out[m] = iw * ih / ua
    return out


def _compute_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-point interpolated AP, loop form (map_boxes _compute_ap)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def mean_average_precision_for_boxes_oracle(
        ann, det, iou_threshold: float) -> Tuple[float, Dict[str, float]]:
    """ann rows: [image_id, label, x1, y1, x2, y2]; det rows:
    [image_id, label, conf, x1, y1, x2, y2] (object arrays or lists).
    Returns (mAP, {label: AP}) at one threshold."""
    ann = np.asarray(ann, object)
    det = np.asarray(det, object)
    ann_imgs = sorted({str(r[0]) for r in ann})
    labels = sorted({str(r[1]) for r in ann})

    all_ann: Dict[str, Dict[str, list]] = {}
    for r in ann:
        all_ann.setdefault(str(r[0]), {}).setdefault(str(r[1]), []).append(
            [float(r[2]), float(r[3]), float(r[4]), float(r[5])])
    all_det: Dict[str, Dict[str, list]] = {}
    for r in det:
        all_det.setdefault(str(r[0]), {}).setdefault(str(r[1]), []).append(
            ([float(r[3]), float(r[4]), float(r[5]), float(r[6])],
             np.float32(float(r[2]))))

    aps: Dict[str, float] = {}
    for label in labels:
        tps, fps, scores = [], [], []
        num_ann = 0
        for img in ann_imgs:
            dets = all_det.get(img, {}).get(label, [])
            anns = all_ann.get(img, {}).get(label, [])
            num_ann += len(anns)
            a = (np.array(anns, np.float64) if anns
                 else np.zeros((0, 4), np.float64))
            claimed = []
            for box, score in dets:          # INPUT ROW ORDER
                scores.append(float(score))  # f32 value, f64 storage
                if a.shape[0] == 0:
                    fps.append(1.0)
                    tps.append(0.0)
                    continue
                overlaps = _compute_overlap_row(
                    np.array(box, np.float64), a)
                j = int(np.argmax(overlaps))
                if overlaps[j] >= iou_threshold and j not in claimed:
                    fps.append(0.0)
                    tps.append(1.0)
                    claimed.append(j)
                else:
                    fps.append(1.0)
                    tps.append(0.0)
        if not scores:
            aps[label] = 0.0
            continue
        scores_arr = np.asarray(scores, np.float64)
        order = np.argsort(-scores_arr)
        tp = np.cumsum(np.asarray(tps, np.float64)[order])
        fp = np.cumsum(np.asarray(fps, np.float64)[order])
        recall = tp / num_ann
        precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
        aps[label] = _compute_ap(recall, precision)

    total = 0.0
    for label in labels:                     # python-order accumulation
        total += aps[label]
    mean_ap = total / len(labels) if labels else 0.0
    return mean_ap, aps


def map50_95_oracle(ann, det) -> Tuple[float, Dict[float, float]]:
    """The stage-3 sweep: independent calls at round(iou, 2) for iou in
    arange(0.5, 1, 0.05), averaged with a python sum
    (reference stage_3.py:54-59 / stage_4.py:996-1004)."""
    per_iou: Dict[float, float] = {}
    for t in np.arange(0.5, 1.0, 0.05):
        thr = round(float(t), 2)
        per_iou[thr], _ = mean_average_precision_for_boxes_oracle(ann, det,
                                                                  thr)
    vals = list(per_iou.values())
    return (sum(vals) / len(vals) if vals else 0.0), per_iou
