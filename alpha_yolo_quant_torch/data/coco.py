"""Local COCO-val dataset reader (counterpart of
alpha_yolo_quant_tpu/data/coco.py, numpy logic unchanged).

Reads a standard local COCO layout (images dir + instances json) and feeds
fixed-shape square-resized batches. PIL is imported only where an image
file is decoded (load_image_square), so a machine without it can still
serve in-memory arrays.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CocoSample:
    image_id: int
    path: str
    orig_hw: Tuple[int, int]
    boxes_xywh: np.ndarray      # (n, 4) original pixel coords
    classes: np.ndarray         # (n,) contiguous 0..79


class CocoValDataset:
    def __init__(self, images_dir: str, annotations_json: str,
                 limit: Optional[int] = None):
        with open(annotations_json) as f:
            coco = json.load(f)
        cat_ids = sorted(c["id"] for c in coco["categories"])
        self.cat_to_idx = {cid: i for i, cid in enumerate(cat_ids)}
        anns_by_img: Dict[int, List] = {}
        for a in coco["annotations"]:
            if a.get("iscrowd", 0):
                continue
            anns_by_img.setdefault(a["image_id"], []).append(a)
        self.samples: List[CocoSample] = []
        for im in coco["images"]:
            anns = anns_by_img.get(im["id"], [])
            boxes = np.array([a["bbox"] for a in anns], np.float64).reshape(
                -1, 4)
            classes = np.array([self.cat_to_idx[a["category_id"]]
                                for a in anns], np.int32)
            self.samples.append(CocoSample(
                image_id=im["id"],
                path=os.path.join(images_dir, im["file_name"]),
                orig_hw=(im["height"], im["width"]),
                boxes_xywh=boxes, classes=classes))
        if limit:
            self.samples = self.samples[:limit]

    def __len__(self):
        return len(self.samples)


def load_image_square(path: str, size: int = 640) -> np.ndarray:
    """RGB float32 CHW in [0,1], square-resized (the reference's
    Resize+ToTensor preprocessing, stage_4.py:980; grayscale promoted)."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size),
                                                 Image.BILINEAR)
    arr = np.asarray(img, np.float32) / 255.0
    return arr.transpose(2, 0, 1)


def batches(ds: CocoValDataset, batch_size: int, size: int = 640
            ) -> Iterator[Tuple[np.ndarray, List[CocoSample]]]:
    """Fixed-shape batches; the tail batch is padded by repeating its last
    sample (padded entries carry sample=None)."""
    buf_img, buf_s = [], []
    for s in ds.samples:
        buf_img.append(load_image_square(s.path, size))
        buf_s.append(s)
        if len(buf_img) == batch_size:
            yield np.stack(buf_img), buf_s
            buf_img, buf_s = [], []
    if buf_img:
        while len(buf_img) < batch_size:
            buf_img.append(buf_img[-1])
            buf_s.append(None)
        yield np.stack(buf_img), buf_s
