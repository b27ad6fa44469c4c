"""Host-side async batch prefetch (counterpart of
alpha_yolo_quant_tpu/data/prefetch.py).

The reference feeds the model image by image from the dataloader thread
(num_workers=0 everywhere, reference stage_3.py:30). Here a small pool
decodes and resizes images and a staging thread copies each batch to the
device ahead of consumption: from pinned host memory with
``non_blocking=True``, on the consumer's CUDA stream, so the step that
reads the batch is ordered after its copy and the pinned block is not
reused before the copy ends (PyTorch's pinned-memory allocator records
the copy on that stream).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from alpha_yolo_quant_torch.data.coco import (
    CocoSample, CocoValDataset, load_image_square,
)


def _decode_u8_hwc(path: str, size: int) -> np.ndarray:
    """Decode+resize to uint8 HWC, the process-pool worker payload: 4x
    fewer IPC bytes than f32 CHW; the float conversion happens vectorized
    on the whole batch in the staging thread."""
    from PIL import Image

    img = Image.open(path).convert("RGB").resize((size, size),
                                                 Image.BILINEAR)
    return np.asarray(img, np.uint8)


def prefetch_batches(ds: CocoValDataset, batch_size: int, size: int = 640,
                     depth: int = 2, decode_workers: int = 4,
                     processes: bool = False, device="cuda"
                     ) -> Iterator[Tuple[torch.Tensor,
                                         List[Optional[CocoSample]]]]:
    """Yield (images, samples) like data.coco.batches, but with image
    decode parallelized and up to `depth` batches staged on `device`
    ahead of the consumer, as float32 tensors there.

    processes: decode in a process pool (spawned, never forked: forking a
    process that already runs CUDA is unsafe; workers return uint8 HWC so
    IPC carries 1.2MB per 640 image instead of 4.9MB). Threads remain the
    default: PIL releases the GIL during JPEG decompression, and processes
    pay a startup + pickling tax that only wins at high image rates."""
    device = torch.device(device)
    # the copies go on the stream of the thread that consumes the batches
    stream = (torch.cuda.current_stream(device)
              if device.type == "cuda" else None)
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = object()

    def stage(imgs: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(imgs)
        if stream is None:
            return t.to(device)
        with torch.cuda.stream(stream):
            return t.pin_memory().to(device, non_blocking=True)

    def producer():
        try:
            if processes:
                import multiprocessing as mp

                pool = ProcessPoolExecutor(
                    max_workers=decode_workers,
                    mp_context=mp.get_context("spawn"))
            else:
                pool = ThreadPoolExecutor(max_workers=decode_workers)
            with pool:
                buf_f, buf_s = [], []

                def flush():
                    if processes:
                        u8 = np.stack([f.result() for f in buf_f])
                        imgs = (u8.astype(np.float32) / 255.0).transpose(
                            0, 3, 1, 2)
                    else:
                        imgs = np.stack([f.result() for f in buf_f])
                    q.put((stage(imgs), list(buf_s)))

                fn = _decode_u8_hwc if processes else load_image_square
                for s in ds.samples:
                    buf_f.append(pool.submit(fn, s.path, size))
                    buf_s.append(s)
                    if len(buf_f) == batch_size:
                        flush()
                        buf_f, buf_s = [], []
                if buf_f:
                    while len(buf_f) < batch_size:
                        buf_f.append(buf_f[-1])
                        buf_s.append(None)
                    flush()
        except BaseException as e:   # re-raised in the consumer
            q.put(e)
        q.put(stop)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            break
        if isinstance(item, BaseException):
            t.join()
            raise item
        yield item
    t.join()
