"""Detection/annotation metric rows (reference utils/coco.py analog).

Rows follow the reference's metric-input convention
(utils/coco.py:152-245): detections are normalized by the model frame
(640), annotations by their own original image size; labels are the COCO-80
class-name strings.

Counterpart of alpha_yolo_quant_tpu/eval/records.py, numpy logic unchanged;
both packages write the same bytes and read each other's files.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

# COCO-80 class names in model output order (reference utils/coco.py:17-98)
COCO_NAMES = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep", "cow",
    "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush",
]


def detection_rows(image_id, det: np.ndarray, n_det: int,
                   frame: float = 640.0) -> List[list]:
    """det: (max_det, 6) rows [x1,y1,x2,y2,conf,cls] from NMS; returns
    metric rows [image_id, label, conf, x1n, y1n, x2n, y2n] normalized by
    the model frame (reference utils/coco.py:152-175)."""
    rows = []
    for i in range(int(n_det)):
        x1, y1, x2, y2, conf, cls = det[i]
        rows.append([str(image_id), COCO_NAMES[int(cls)], float(conf),
                     float(x1) / frame, float(y1) / frame,
                     float(x2) / frame, float(y2) / frame])
    return rows


def annotation_rows(image_id, boxes_xywh: Sequence[Sequence[float]],
                    classes: Sequence[int], orig_hw) -> List[list]:
    """COCO-format xywh GT boxes in original pixel coords -> normalized
    xyxy rows [image_id, label, x1n, y1n, x2n, y2n]
    (reference utils/coco.py:178-197)."""
    h, w = orig_hw
    rows = []
    for (x, y, bw, bh), c in zip(boxes_xywh, classes):
        rows.append([str(image_id), COCO_NAMES[int(c)],
                     float(x) / w, float(y) / h,
                     float(x + bw) / w, float(y + bh) / h])
    return rows


def save_csv_tables(ann_rows: List[list], det_rows: List[list],
                    out_dir: str, tag: str):
    """Persist the per-run detection/annotation tables like the
    reference's CSV archival (stage_3.py:48-49, stage_8_torch.py:
    1020-1026). Column order matches the reference DataFrames —
    XMin,YMin,XMax,YMax,ImageID,LabelName[,Conf] (utils/coco.py:166-175);
    file names follow ann_orig/det_orig and det_QUANT_{K}_channel."""
    import csv
    import os

    os.makedirs(os.path.join(out_dir, "results"), exist_ok=True)
    ann_path = os.path.join(out_dir, "results", f"ann_{tag}.csv")
    det_path = os.path.join(out_dir, "results", f"det_{tag}.csv")
    with open(ann_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["XMin", "YMin", "XMax", "YMax", "ImageID", "LabelName"])
        for r in ann_rows:  # [id, label, x1, y1, x2, y2]
            w.writerow([r[2], r[3], r[4], r[5], r[0], r[1]])
    with open(det_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["XMin", "YMin", "XMax", "YMax", "ImageID", "LabelName",
                    "Conf"])
        for r in det_rows:  # [id, label, conf, x1, y1, x2, y2]
            w.writerow([r[3], r[4], r[5], r[6], r[0], r[1], r[2]])
    return ann_path, det_path


def to_metric_arrays(ann_rows: List[list], det_rows: List[list]):
    """Pack rows for eval.metrics (ann: id,label,x1,y1,x2,y2;
    det: id,label,conf,x1,y1,x2,y2)."""
    ann = np.array([[r[0], r[1], r[2], r[3], r[4], r[5]] for r in ann_rows],
                   object)
    det = np.array([[r[0], r[1], r[2], r[3], r[4], r[5], r[6]]
                    for r in det_rows], object)
    return ann, det
