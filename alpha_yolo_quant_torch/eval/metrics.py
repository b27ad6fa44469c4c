"""mean-average-precision, exactly map_boxes-compatible.

The reference feeds [ImageID, LabelName, (coords)] annotation rows and
[ImageID, LabelName, Conf, (coords)] detection rows into the external
``map_boxes.mean_average_precision_for_boxes`` (reference
stage_3.py:51-59), sweeping IoU 0.50..0.95 and averaging for mAP50-95.
This module is a vectorized implementation of THAT metric — every
semantic corner follows the package's algorithm, not textbook VOC:

  * classes = sorted unique annotation labels; detection-only classes
    are ignored; the mean runs over all annotation classes;
  * the image loop covers sorted unique ANNOTATION image ids only —
    detections on images without any annotation rows are skipped
    entirely (not false positives);
  * within an image, detections match in INPUT ROW ORDER (not
    confidence order); each claims only its argmax-IoU ground truth
    (first index on ties), TP iff overlap >= threshold and unclaimed;
  * confidences are float32-cast; the PR curve orders the TP/FP
    sequence by np.argsort(-scores) over the image-major sequence, so
    tied scores reproduce the package's exact permutation;
  * overlaps use iw/ih > 0 guards and no union epsilon; precision
    divides by max(tp+fp, float64 eps); AP is all-point interpolation.

Differentially validated against the loop-for-loop oracle transcription
in eval/map_oracle.py — bit-EQUAL per-class APs and means on thousands
of fuzz cases including duplicate detections, IoU and confidence ties,
degenerate boxes, and ann-less images (tests/test_torch_eval.py).
Vectorization: one IoU matrix and one argmax per
(class, image) group, shared across ALL ten IoU thresholds.

Counterpart of alpha_yolo_quant_tpu/eval/metrics.py, numpy logic unchanged;
both packages write the same bytes and read each other's files.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_EPS = float(np.finfo(np.float64).eps)


def _ap_from_pr(recall: np.ndarray, precision: np.ndarray) -> float:
    """All-point interpolated AP (bitwise-equal to map_boxes
    _compute_ap's backward-max loop)."""
    mrec = np.concatenate(([0.0], recall, [1.0]))
    mpre = np.concatenate(([0.0], precision, [0.0]))
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _overlap_matrix(det: np.ndarray, ann: np.ndarray) -> np.ndarray:
    """det: (N,4), ann: (M,4) xyxy float64 -> (N,M) overlap with
    map_boxes compute_overlap semantics: iw/ih guarded > 0, union =
    det_area + ann_area - inter, no epsilon (degenerate unions divide
    as-is, matching the scalar loop bit-for-bit)."""
    iw = (np.minimum(det[:, None, 2], ann[None, :, 2])
          - np.maximum(det[:, None, 0], ann[None, :, 0]))
    ih = (np.minimum(det[:, None, 3], ann[None, :, 3])
          - np.maximum(det[:, None, 1], ann[None, :, 1]))
    pos = (iw > 0) & (ih > 0)
    inter = iw * ih
    det_area = (det[:, 2] - det[:, 0]) * (det[:, 3] - det[:, 1])
    ann_area = (ann[:, 2] - ann[:, 0]) * (ann[:, 3] - ann[:, 1])
    ua = det_area[:, None] + ann_area[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(pos, inter / ua, 0.0)


class _ClassEval:
    """Threshold-independent matching state for one class.

    Detections are laid out in the metric's canonical order — sorted
    annotation image ids, input row order within each image — so index
    comparisons reproduce the greedy claim sequence:
      vmax[i]   overlap against detection i's argmax ground truth
      jkey[i]   globally-unique index of that ground truth (-1: none)
      scores[i] float32-cast confidence (float64 storage)
      n_gt      ground truths of this class over the annotation images
    """

    __slots__ = ("vmax", "jkey", "scores", "n_gt", "n_det")

    def __init__(self, gt_by_img: Dict[str, np.ndarray],
                 det_by_img: Dict[str, list], ann_imgs: List[str]):
        self.n_gt = sum(len(gt_by_img.get(img, ())) for img in ann_imgs)
        vmax, jkey, scores = [], [], []
        base = 0
        for img in ann_imgs:
            gts = gt_by_img.get(img)
            m = 0 if gts is None else len(gts)
            rows = det_by_img.get(img, ())
            if rows:
                boxes = np.array([r[1] for r in rows], np.float64)
                scores.extend(np.float32(r[0]) for r in rows)
                if m:
                    ious = _overlap_matrix(boxes, gts)
                    j = np.argmax(ious, axis=1)
                    vmax.extend(ious[np.arange(len(rows)), j])
                    jkey.extend(base + j)
                else:
                    vmax.extend([0.0] * len(rows))
                    jkey.extend([-1] * len(rows))
            base += m
        self.n_det = len(scores)
        self.vmax = np.asarray(vmax, np.float64)
        self.jkey = np.asarray(jkey, np.int64)
        self.scores = np.asarray(scores, np.float64)

    def ap_at(self, iou_threshold: float) -> float:
        """Greedy first-claimant matching at one threshold -> AP."""
        if self.n_det == 0:
            return 0.0
        elig = (self.vmax >= iou_threshold) & (self.jkey >= 0)
        tp = np.zeros(self.n_det, np.float64)
        e = np.nonzero(elig)[0]
        if len(e):
            # first eligible claimant (lowest canonical index — input
            # order within its image) of each ground truth wins; later
            # claimants of the same gt are FPs and claim nothing else
            winner = np.full(max(self.n_gt, 1), self.n_det, np.int64)
            np.minimum.at(winner, self.jkey[e], e)
            tp[e[winner[self.jkey[e]] == e]] = 1.0
        order = np.argsort(-self.scores)     # the package's exact sort
        tp = tp[order]
        ctp = np.cumsum(tp)
        cfp = np.cumsum(1.0 - tp)
        recall = ctp / self.n_gt
        precision = ctp / np.maximum(ctp + cfp, _EPS)
        return _ap_from_pr(recall, precision)


def _prepare(ann: np.ndarray, det: np.ndarray) -> Dict[str, _ClassEval]:
    """Group rows by class and build the threshold-independent per-class
    matching state over the sorted annotation image ids."""
    ann = np.asarray(ann, object)
    det = np.asarray(det, object)
    labels = sorted({str(r[1]) for r in ann})
    ann_imgs = sorted({str(r[0]) for r in ann})
    gt_by_label: Dict[str, Dict[str, list]] = {lb: {} for lb in labels}
    for r in ann:
        gt_by_label[str(r[1])].setdefault(str(r[0]), []).append(
            [float(r[2]), float(r[3]), float(r[4]), float(r[5])])
    det_by_label: Dict[str, Dict[str, list]] = {lb: {} for lb in labels}
    for r in det:
        lb = str(r[1])
        if lb in det_by_label:
            det_by_label[lb].setdefault(str(r[0]), []).append(
                (float(r[2]), [float(r[3]), float(r[4]),
                               float(r[5]), float(r[6])]))
    out: Dict[str, _ClassEval] = {}
    for lb in labels:
        gt = {img: np.array(v, np.float64)
              for img, v in gt_by_label[lb].items()}
        out[lb] = _ClassEval(gt, det_by_label[lb], ann_imgs)
    return out


def _mean(aps: Dict[str, float]) -> float:
    """Sorted-class python-order accumulation, like the package."""
    if not aps:
        return 0.0
    total = 0.0
    for lb in sorted(aps):
        total += aps[lb]
    return total / len(aps)


def average_precision(ann: np.ndarray, det: np.ndarray,
                      iou_threshold: float) -> Tuple[float, Dict[str, float]]:
    """ann rows: [image_id, label, x1, y1, x2, y2];
    det rows: [image_id, label, conf, x1, y1, x2, y2] (object dtype ok).

    Returns (mAP, per-class AP) at one IoU threshold, with
    map_boxes.mean_average_precision_for_boxes semantics (module
    docstring; classes without annotations never appear because classes
    are DEFINED by the annotation rows)."""
    classes = _prepare(ann, det)
    aps = {lb: ce.ap_at(iou_threshold) for lb, ce in classes.items()}
    return _mean(aps), aps


def map50_95(ann: np.ndarray, det: np.ndarray) -> Tuple[float, Dict]:
    """The reference's headline metric: mean AP over IoU round(t, 2) for
    t in arange(0.5, 1, 0.05), python-summed (reference stage_3.py:
    54-59 — the thresholds ARE rounded there, so an overlap of exactly
    0.85 counts at the 0.85 gate). The per-class matching state is
    built once and shared across the ten thresholds."""
    classes = _prepare(ann, det)
    per_iou = {}
    for t in np.arange(0.5, 1.0, 0.05):
        thr = round(float(t), 2)
        per_iou[thr] = _mean({lb: ce.ap_at(thr)
                              for lb, ce in classes.items()})
    vals = list(per_iou.values())
    return (sum(vals) / len(vals) if vals else 0.0), per_iou
