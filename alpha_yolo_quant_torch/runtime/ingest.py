"""Staged ingest: a request's images from host memory to the card through a
small ring of pinned host chunks.

``torch.as_tensor(images, device="cuda")`` on pageable host memory is one
blocking copy that CUDA stages through a pinned buffer of its own, about
6 GB/s on an H100's host. Here each call copies its bytes chunk by chunk:
the host copies a chunk from the caller's array into a free pinned slot
(``Tensor.copy_``, on torch's intra-op threads), enqueues the slot's copy
to the card on a copy stream of the pipeline's own, and goes on to the next
chunk while the DMA engine moves this one. A slot is refilled only after
the event recorded behind its last copy has completed. The caller's
stream waits for the last copy, so what follows runs after it.

What the ring never does: pin or register the caller's memory, keep
anything keyed on it, or keep a device copy of an earlier request. Every
call copies all of its bytes before it returns, so the caller may reuse
its array at once. The device tensor comes from the caching allocator on
every call, on the caller's stream, which the copy stream waits for
before it writes.

``STAGED`` counts the staged calls, chunks and bytes since the last
``reset_counts()``; a call that does not stage (a CPU pipeline, an input
already on the card) counts nothing.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Tuple

import torch

from alpha_yolo_quant_torch.utils.profiling import span

# Bytes a chunk and slots in the ring, measured on an H100's host over
# B=128 640-px uint8 batches (PERF.md): each chunk's host copy is one
# parallel region of torch's threads, which wait for the slowest of them,
# so chunks of 1-2 MiB cost 15-24 ms a batch, and while other processes
# held the host's cores 32 MiB chunks kept the gain that 16 MiB ones lost;
# two slots suffice, because the host's copy of a chunk outlasts its DMA
CHUNK_BYTES = 32 << 20
SLOTS = 2

# staged calls, chunks and bytes since the last reset_counts()
STAGED: Dict[str, int] = {"calls": 0, "chunks": 0, "bytes": 0}


def reset_counts() -> None:
    for k in STAGED:
        STAGED[k] = 0


def chunk_plan(n_bytes: int, chunk_bytes: int) -> List[Tuple[int, int]]:
    """The byte bounds ``[(lo, hi), ...]`` of the chunks of an
    ``n_bytes`` copy: in order, covering it once, each at most
    ``chunk_bytes`` and only the last shorter."""
    return [(lo, min(lo + chunk_bytes, n_bytes))
            for lo in range(0, n_bytes, chunk_bytes)]


class StagedIngest:
    """``ingest(images)``: ``images`` (numpy or torch) as a tensor on
    ``device``, equal to ``torch.as_tensor(images, device=device)``.

    On a CUDA device, host images are staged through the ring; on a CPU
    device, and for a tensor already on a card, this is
    ``torch.as_tensor`` (the tensor passes through). The ring's slots are
    allocated on first use, as many as the largest request's chunks up to
    ``SLOTS``, each as large as its largest chunk, and reused by every
    later call. A lock keeps two threads calling one pipeline from sharing
    a slot."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._slots: List[list] = []    # [pinned uint8 tensor, event]
        self._stream = None

    def __call__(self, images) -> torch.Tensor:
        if self.device.type != "cuda" or (
                isinstance(images, torch.Tensor)
                and images.device.type != "cpu"):
            return torch.as_tensor(images, device=self.device)
        return self._staged(torch.as_tensor(images).contiguous())

    def _ring(self, n: int, n_bytes: int) -> List[list]:
        """The first ``n`` slots, each of at least ``n_bytes``."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        while len(self._slots) < n:
            self._slots.append([None, torch.cuda.Event()])
        for slot in self._slots[:n]:
            if slot[0] is None or slot[0].numel() < n_bytes:
                # a slot replaced while its copy runs stays held by the
                # pinned allocator until the copy's stream passes it
                slot[0] = torch.empty(n_bytes, dtype=torch.uint8,
                                      pin_memory=True)
        return self._slots[:n]

    def _staged(self, src: torch.Tensor) -> torch.Tensor:
        out = torch.empty(src.shape, dtype=src.dtype, device=self.device)
        plan = chunk_plan(src.numel() * src.element_size(), CHUNK_BYTES)
        if not plan:
            return out
        src_b = src.reshape(-1).view(torch.uint8)
        out_b = out.view(-1).view(torch.uint8)
        caller = torch.cuda.current_stream(self.device)
        with self._lock:
            ring = self._ring(min(SLOTS, len(plan)), plan[0][1] - plan[0][0])
            stream = self._stream
            # out's block may have been freed by work still queued on the
            # caller's stream
            stream.wait_stream(caller)
            for i, (lo, hi) in enumerate(plan):
                buf, done = ring[i % len(ring)]
                if not done.query():
                    with span("ayq.ingest.wait"):
                        done.synchronize()
                with span("ayq.ingest.stage"):
                    buf[:hi - lo].copy_(src_b[lo:hi])
                    with torch.cuda.stream(stream):
                        out_b[lo:hi].copy_(buf[:hi - lo], non_blocking=True)
                        done.record(stream)
            caller.wait_stream(stream)
            STAGED["calls"] += 1
            STAGED["chunks"] += len(plan)
            STAGED["bytes"] += plan[-1][1]
        return out
