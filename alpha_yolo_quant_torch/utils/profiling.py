"""Tracing and profiling utilities (counterpart of
alpha_yolo_quant_tpu/utils/profiling.py): the program's spans, a
torch.profiler trace of a block (CPU and CUDA activity, written as a
chrome trace), a timer of one call on the card, and the card's name and
power limit.

``span(name)`` marks a stage of the serving pipeline for torch.profiler.
While a ``torch.profiler.profile`` is active it is a
``torch.profiler.record_function``: the span lands in the same trace as
the kernels, and every kernel and copy links to the runtime call that
launched it (``args.correlation`` in the chrome trace), so device time
and device idle time can be put down to the span that was open on the
host. Otherwise it is one shared ``contextlib.nullcontext()``: a flag
read and no name formatted. There is no switch of its own: spans are on
exactly while a profiler is. ``SPANS`` lists every name.

engine_profile.device_ms is the other timer of the port: it queues the
calls behind a busy wait of the card so that a call shorter than its
launch cost still reads as device time. bench_fn times what a caller
waits for, launch cost included."""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# The program's spans, name -> what it covers. A dotted name nests in the
# span its prefix names (``ayq.nms.sweep`` in ``ayq.nms`` in ``ayq``); a
# name ending in "." takes a suffix, one span name per conv layer.
SPANS = {
    "ayq": "one call of build_int_pipeline's fn (plain or coalesced); its "
           "self time is the program's Python between stages",
    "ayq.ingest": "a request to the pipeline's device: on a CUDA device "
                  "host images are staged chunk by chunk through a ring of "
                  "pinned slots (runtime/ingest.py), else torch.as_tensor",
    "ayq.ingest.stage": "one chunk: the host copy into a pinned slot and "
                        "the enqueue of its copy to the card; its instances "
                        "a call are the chunk count",
    "ayq.ingest.wait": "a wait for a slot's last copy to end before the "
                       "slot is refilled: the host outran the DMA",
    "ayq.quantize": "quantize_input: the input quantizer",
    "ayq.forward": "the padding, int_forward (or the sharded forward of "
                   "parallel/mesh.py) and the slice back",
    "ayq.forward.conv.": "one conv layer, by ConvNode.name: the kernel "
                         "call and its wrapper (dwconv3x3 for a depthwise "
                         "conv)",
    "ayq.forward.attn.": "one attention node, by AttentionNode.name: "
                         "fused_ops.attention, one launch of csrc/attn.cu",
    "ayq.forward.split": "a SplitNode's two channel halves",
    "ayq.forward.add": "a ResidualAddNode: requant, add, clamp and cast "
                       "as one requant_combine_kernel launch "
                       "(csrc/glue.cu, fused_ops.residual_add)",
    "ayq.forward.concat": "a ConcatNode: every source's requant, cast and "
                          "channel offset as one requant_combine_kernel "
                          "launch (csrc/glue.cu, fused_ops.concat)",
    "ayq.forward.maxpool": "a MaxPoolNode",
    "ayq.forward.upsample": "an UpsampleNode",
    "ayq.forward.slab": "one SlabExec.run of the packed engine's slab ops",
    "ayq.forward.head_requant": "requant_heads: the full-quant head's "
                                "first requant",
    "ayq.decode": "the decode that runs: decode_select_sparse, "
                  "decode_serving, decode_full_quant or decode_float",
    "ayq.decode.level.": "one detect level of the serving decode's level "
                         "loop, by level (p3, p4, ...): its DFL, anchors "
                         "and class max (decode_serving), or its class "
                         "max, anchors and flattening "
                         "(decode_select_sparse)",
    "ayq.nms": "non_max_suppression",
    "ayq.nms.select": "_select_candidates: sort and gather of the top "
                      "candidates",
    "ayq.nms.suppress": "greedy_keep_sorted's areas and (B, M, M) "
                        "suppress matrix",
    "ayq.nms.sweep": "one Jacobi sweep of greedy_keep_sorted: gemv, compare "
                     "and the torch.equal host sync; its instances a batch "
                     "are the sweep counter",
    "ayq.nms.compact": "the kept rows to the front: sort, gathers, score "
                       "map, descale and the det fill",
}

_OFF = contextlib.nullcontext()


def span(name: str, suffix: str = ""):
    """The span ``name + suffix`` (a name of ``SPANS``) while torch's
    profiler is on, else the shared null context; the name is joined only
    when the span is on."""
    if _autograd_profiler._is_profiler_enabled:
        return _autograd_profiler.record_function(name + suffix)
    return _OFF


def card_name(device="cuda") -> str:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, or
    its name from torch where nvidia-smi is absent: written beside every
    number taken on the card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return out[0] if out else torch.cuda.get_device_name(device)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """torch.profiler over the block, CPU and CUDA activity; on exit the
    trace is written to ``log_dir`` as a chrome trace (open it in
    chrome://tracing or Perfetto). Yields the trace file's path, or None
    and does nothing when log_dir is None."""
    if log_dir is None:
        yield None
        return
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


def bench_fn(fn, *args, iters: int = 10, warmup: int = 2,
             device="cuda") -> float:
    """Milliseconds per call of ``fn(*args)``: ``warmup`` calls, then on
    a CUDA device a synchronize and CUDA events around ``iters`` calls;
    on ``device="cpu"`` the host clock around them. A CUDA device without
    a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_fn: no CUDA device; pass device='cpu' to "
                           "time on the CPU")
    for _ in range(warmup):
        fn(*args)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(dev)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn(*args)
    t1.record()
    torch.cuda.synchronize(dev)
    return t0.elapsed_time(t1) / iters
