"""Request-coalescing serving layer (counterpart of
alpha_yolo_quant_tpu/serving.py).

Every per-image computation of the pipeline is batch independent, so
running several queued requests through one batched call changes no
request's rows: the outputs equal per-request calls bit for bit
(tests/test_torch_serving.py).

Three surfaces:

- :func:`split_by_sizes` — the request seam's one slicing rule.
- :func:`coalesced_fn` — the static seam: one step over ``n_requests``
  requests, outputs split back per request.
- :class:`BatchCoalescer` — the dynamic seam: a thread-safe batcher that
  queues ``submit()``-ed requests of any size and flushes them through one
  call when the target batch fills or the oldest request times out.

The one planned difference from the JAX module: a flush runs at its real
row count. The JAX coalescer zero-pads every flush to ``max_batch`` so
that XLA keeps one compiled program; eager PyTorch needs no such padding,
and the outputs are the same either way.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import List, Sequence, Tuple

import numpy as np
import torch


def _tree_map(f, tree):
    """Apply ``f`` to every leaf of a tensor/array tree (a leaf, or a
    tuple/list/dict of them, nested)."""
    if isinstance(tree, dict):
        return {k: _tree_map(f, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(f, v) for v in tree)
    return f(tree)


def split_by_sizes(tree, sizes: Sequence[int]) -> tuple:
    """Split every tensor of ``tree`` (a tensor, or a tuple/list/dict of
    them, nested) along dim 0 into consecutive row blocks of ``sizes``."""
    parts, off = [], 0
    for s in sizes:
        parts.append(_tree_map(lambda t, o=off, s=s: t[o:o + s], tree))
        off += s
    return tuple(parts)


def _to_numpy(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def coalesced_fn(fn, n_requests: int = 2):
    """Wrap a batched pipeline ``fn`` as one step over ``n_requests``
    requests: concatenates them along the batch, runs ``fn`` once, and
    splits every output leaf back per request (every leaf must carry the
    batch on dim 0, true of (det, n_det) and of the with_nms=False
    preds). Requests are numpy arrays or tensors; bitwise identical to
    calling ``fn`` per request."""

    def step(*requests):
        if len(requests) != n_requests:
            raise ValueError(f"expected {n_requests} requests, "
                             f"got {len(requests)}")
        sizes = [r.shape[0] for r in requests]
        out = fn(torch.cat([torch.as_tensor(r) for r in requests], 0))
        return split_by_sizes(out, sizes)

    return step


class BatchCoalescer:
    """Dynamic request batcher over one pipeline function.

    ``fn`` maps a batch of images to outputs with the batch on dim 0 of
    every leaf (build_int_pipeline's fn). ``submit`` returns a ``Future``
    resolving to ``fn``'s outputs sliced to the request's rows (numpy, on
    the host). A flush runs at its real row count, at most ``max_batch``.

    Flush policy: as soon as queued rows fill ``max_batch`` (taking whole
    requests only: a request never spans two flushes), or when the oldest
    queued request has waited ``max_wait_ms``. The knob trades tail
    latency for fill.
    """

    def __init__(self, fn, max_batch: int = 128,
                 max_wait_ms: float = 5.0,
                 image_shape: Sequence[int] = (3, 640, 640),
                 dtype=np.float32):
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._image_shape = tuple(image_shape)
        self._dtype = np.dtype(dtype)
        self._step = fn
        self._lock = threading.Condition()
        self._queue: List[Tuple[np.ndarray, Future, float]] = []
        self._closed = False
        # observability: counters + a bounded per-request latency window
        self._n_requests = 0
        self._n_images = 0
        self._n_flushes = 0
        self._fill_sum = 0
        self._latencies: List[float] = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def snapshot(self) -> dict:
        """Serving stats since construction: request/image/flush counts,
        mean flush fill (real rows / max_batch), and p50/p95/p99 request
        latency in ms over the last <=4096 completed requests."""
        with self._lock:
            lat = sorted(self._latencies)
            n_req, n_img = self._n_requests, self._n_images
            n_fl, fill = self._n_flushes, self._fill_sum
        q = (lambda p: 1e3 * lat[min(len(lat) - 1,
                                     int(p * len(lat)))]) if lat else \
            (lambda p: float("nan"))
        return {
            "requests": n_req, "images": n_img, "flushes": n_fl,
            "mean_fill": (fill / (n_fl * self.max_batch)) if n_fl else 0.0,
            "latency_ms_p50": q(0.50), "latency_ms_p95": q(0.95),
            "latency_ms_p99": q(0.99),
        }

    def submit(self, images) -> Future:
        """Queue one request of ``(b, *image_shape)`` images,
        1 <= b <= max_batch. Returns a Future of fn's outputs for these
        rows."""
        images = np.asarray(images, self._dtype)
        if (images.ndim != 1 + len(self._image_shape)
                or images.shape[1:] != self._image_shape):
            raise ValueError(
                f"request shape {images.shape} != "
                f"(b, {', '.join(map(str, self._image_shape))})")
        if not 1 <= images.shape[0] <= self.max_batch:
            raise ValueError(
                f"request batch {images.shape[0]} outside "
                f"[1, {self.max_batch}]")
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("coalescer is closed")
            self._queue.append((images, fut, time.monotonic()))
            self._lock.notify()
        return fut

    def _take_flush(self):
        """Under the lock: pop a prefix of whole requests filling at
        most max_batch. Called when full or timed out."""
        take, total = [], 0
        while self._queue:
            b = self._queue[0][0].shape[0]
            if total + b > self.max_batch:
                break
            total += b
            take.append(self._queue.pop(0))
        return take

    def _run(self):
        try:
            while True:
                with self._lock:
                    while True:
                        if self._queue:
                            total = sum(r[0].shape[0]
                                        for r in self._queue)
                            oldest_wait = (time.monotonic()
                                           - self._queue[0][2])
                            if (total >= self.max_batch
                                    or oldest_wait >= self.max_wait_s
                                    or self._closed):
                                batch = self._take_flush()
                                break
                            self._lock.wait(self.max_wait_s - oldest_wait)
                        elif self._closed:
                            return
                        else:
                            self._lock.wait()
                if batch:
                    self._execute(batch)
        except BaseException as e:
            # a worker death must never hang submitters: fail every
            # queued future and refuse further submits
            with self._lock:
                self._closed = True
                pending, self._queue = self._queue, []
            for _, fut, _ in pending:
                if not fut.done():
                    fut.set_exception(e)
            raise

    def _execute(self, batch):
        try:
            sizes = [img.shape[0] for img, _, _ in batch]
            total = sum(sizes)
            x = np.concatenate([img for img, _, _ in batch], axis=0)
            out = _tree_map(_to_numpy, self._step(x))
            done = time.monotonic()
            # count the flush before resolving its futures, so that a
            # snapshot taken after a result() includes that request
            with self._lock:
                self._n_requests += len(batch)
                self._n_images += total
                self._n_flushes += 1
                self._fill_sum += total
                self._latencies.extend(done - t0 for _, _, t0 in batch)
                if len(self._latencies) > 4096:
                    del self._latencies[:-4096]
            for (_, fut, _), part in zip(batch, split_by_sizes(out, sizes)):
                fut.set_result(part)
        except BaseException as e:  # propagate to every waiter
            for _, fut, _ in batch:
                if not fut.done():
                    fut.set_exception(e)
            if not isinstance(e, Exception):
                # worker-fatal (SystemExit & co.): re-raise so _run's
                # handler also fails still-queued futures and closes;
                # otherwise in-flight submitters would hang forever
                raise

    def close(self):
        """Flush anything queued, then stop the worker."""
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._worker.join(timeout=60)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
