"""Batched COCO-val evaluation harness, the stage-3/4/8 loops (counterpart
of alpha_yolo_quant_tpu/eval/harness.py).

One step runs forward + decode + NMS for a whole batch; detections come
back as fixed-shape (B, max_det, 6) arrays and are turned into metric rows
on the host. The reference loops images one at a time on the host
(stage_4.py:975-1011).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List

import numpy as np
import torch

from alpha_yolo_quant_torch.data.coco import CocoValDataset, batches
from alpha_yolo_quant_torch.eval.metrics import map50_95
from alpha_yolo_quant_torch.eval.records import (
    annotation_rows, detection_rows, to_metric_arrays,
)


@dataclasses.dataclass
class EvalResult:
    map50_95: float
    per_iou: Dict[float, float]
    n_images: int
    images_per_s: float          # step time only (see evaluate)
    images_per_s_wall: float = 0.0   # host-inclusive: decode+feed+metrics
    wall_s: float = 0.0
    # raw metric rows, kept for the reference's CSV archival contract
    # (records.save_csv_tables; stage_3.py:48-49, stage_8_torch.py:1026)
    ann_rows: List[list] = dataclasses.field(default_factory=list)
    det_rows: List[list] = dataclasses.field(default_factory=list)


def _synchronize() -> None:
    """Wait for the card's queued work, where this process uses one."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _host(t) -> np.ndarray:
    """A step output on the host; for a device tensor this waits for the
    step that writes it."""
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def evaluate(step: Callable, ds: CocoValDataset, batch_size: int = 16,
             image_size: int = 640, progress: bool = False,
             prefetch: bool = False, device="cuda") -> EvalResult:
    """step(images f32 (B,3,S,S), numpy or a tensor) -> (det
    (B,max_det,6), n_det (B,)), tensors on any device or numpy arrays.

    Boxes are expected in the model frame; annotations are normalized by
    the original image size per the reference convention (detections stay
    in the 640 frame because the reference's `orig_img` is the resized
    tensor: stage_4.py:476, utils/coco.py:152-175).

    images_per_s counts the step's time: the clock starts after a
    torch.cuda.synchronize(), so work queued earlier is not billed to it,
    and runs through the step call and the synchronizing copy of its
    det/n_det to the host, so a step whose work is still queued when it
    returns is not counted as free. images_per_s_wall counts everything.

    prefetch: decode and stage the next batches on background threads
    while the step runs (data.prefetch, copies to `device`), and fetch
    each batch's detections only after the next batch's step was called,
    so host metric work could overlap device work. The overlap needs a
    step that returns before the device finishes; the port's q_NMS waits
    for the device on every sweep of its keep loop
    (postprocess/nms.greedy_keep_sorted), so today the overlap is about
    nil. In this mode images_per_s counts the step calls and the residual
    wait at each fetch, and wall is the meaningful figure.
    """
    ann_rows: List[list] = []
    det_rows: List[list] = []
    n_img = 0
    t_dev = 0.0
    t_wall0 = time.perf_counter()
    if prefetch:
        from alpha_yolo_quant_torch.data.prefetch import prefetch_batches

        batch_iter = prefetch_batches(ds, batch_size, image_size,
                                      device=device)
    else:
        batch_iter = batches(ds, batch_size, image_size)

    def drain(out, samples):
        nonlocal n_img, t_dev
        t0 = time.perf_counter()
        det, n_det = (_host(t) for t in out)
        t_dev += time.perf_counter() - t0
        for b, s in enumerate(samples):
            if s is None:
                continue
            n_img += 1
            ann_rows.extend(annotation_rows(s.image_id, s.boxes_xywh,
                                            s.classes, s.orig_hw))
            det_rows.extend(detection_rows(s.image_id, det[b],
                                           int(n_det[b]),
                                           frame=float(image_size)))
        if progress:
            print(f"\r{n_img}/{len(ds)}", end="", flush=True)

    pending = None
    for imgs, samples in batch_iter:
        _synchronize()
        t0 = time.perf_counter()
        out = step(imgs)
        t_dev += time.perf_counter() - t0
        if prefetch:
            if pending is not None:
                drain(*pending)
            pending = (out, samples)
        else:
            drain(out, samples)
    if pending is not None:
        drain(*pending)
    if progress:
        print()
    ann, det_arr = to_metric_arrays(ann_rows, det_rows)
    m, per_iou = map50_95(ann, det_arr)
    wall = time.perf_counter() - t_wall0
    return EvalResult(map50_95=m, per_iou=per_iou, n_images=n_img,
                      images_per_s=n_img / t_dev if t_dev else 0.0,
                      images_per_s_wall=n_img / wall if wall else 0.0,
                      wall_s=wall, ann_rows=ann_rows, det_rows=det_rows)
