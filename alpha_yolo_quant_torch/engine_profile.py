"""Where a B=128 serving batch spends its device time, per engine.

    python3 -m alpha_yolo_quant_torch.engine_profile

Needs one CUDA card (and nvcc for the kernels). Builds the model that
chip_smoke.py serves (yolov8n K=8 full quant 640, random weights from seed
0, the port's calibration on two seeded images) and, for each engine
(fused, pallas, packed): CUDA events around quantize, int_forward and the
decode + q_NMS tail of one batch, then one torch.profiler pass over a
whole batch with the device time summed by kernel, the port's kernels by
name and the rest as torch ops. Prints one JSON line per engine, then one
line (`conv_layers`) with each conv of the fused forward timed alone on
the activations that forward feeds it: its device time, the time with the
raw int32 epilogue instead of the SiLU chain, and its bound; then one
(`packed_layers`) with each slab conv of the packed forward timed alone
on the slabs that forward feeds it, its bound and the share of blocks its
tap masks keep.
"""

from __future__ import annotations

import json
import subprocess
from collections import defaultdict

import numpy as np
import torch

from alpha_yolo_quant_torch.runtime import fused_ops
from alpha_yolo_quant_torch.runtime.interpreter import (
    build_int_pipeline, int_forward, quantize_input,
)

BATCH = 128
# one NVIDIA H100 SXM (data sheet, dense): HBM bytes/s, int8 tensor ops/s
HBM_BPS = 3.35e12
INT8_OPS = 1.979e15
SPIN_CYCLES = 40_000_000   # about 20 ms of the card at its boost clock
# device-side names of the port's kernels (runtime/csrc) -> report label
PORT_KERNELS = {"conv_wgmma": "conv1x1/conv3x3", "postconv_kernel":
                "postconv", "packed_conv_kernel": "packed_conv",
                "sigma_probe_kernel": "sigma_probe"}


def build_model(image_size: int = 640, device="cuda",
                full_quant: bool = True):
    """yolov8n K=8 full quant (or partial), random weights from seed 0,
    calibrated by the port's float forward on two seeded images (the model
    chip_smoke.py serves)."""
    from alpha_yolo_quant_torch.config import QuantConfig
    from alpha_yolo_quant_torch.models.graph import build_yolov8_graph
    from alpha_yolo_quant_torch.models.params import init_params
    from alpha_yolo_quant_torch.quantize.calibrate import (
        collect_stats, reduce_stats,
    )
    from alpha_yolo_quant_torch.quantize.transform import (
        build_quantized_model,
    )

    cfg = QuantConfig(model="yolov8n", k=8, full_quant=full_quant,
                      image_size=image_size)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=0)
    calib = np.random.default_rng(1).uniform(
        0, 1, (2, 3, image_size, image_size)).astype(np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib], device),
                         "max", cfg.k)
    return build_quantized_model(graph, params, max_a, cfg)


def device_ms(fn, reps: int, warmup: int = 1, spin: bool = True) -> float:
    """Mean milliseconds per call, CUDA events around `reps` calls after a
    warm-up and a synchronize. With `spin` the calls queue behind a busy
    wait of the card (torch.cuda._sleep), so the time is the card's alone
    even where a call is shorter than the host's cost of making it;
    without it the host's launch cost shows in short calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if spin:
        torch.cuda._sleep(SPIN_CYCLES)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the least time the card could take, bytes at
    the HBM rate against operations at the dense int8 tensor rate."""
    t_bytes, t_ops = n_bytes / HBM_BPS, n_ops / INT8_OPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def packed_bound(x_slabs, taps, e, out, m: int):
    """(bound_ms, bound_by, useful MACs) of one packed_call: every input
    slab read once, the output slab written once, the tap matrices and
    lane constants read once; the MACs are the nonzero weights of the taps
    over the m rows of each image."""
    nnz = sum(int(torch.count_nonzero(e["w_f64"][t])) for _, t, _ in taps)
    macs = out.shape[0] * m * nnz
    b_ms, b_by = bound(nbytes(*x_slabs, out, e["w_blocks"], e["b"], e["r1"],
                              e["s1"], e["r2"], e["s2"]), 2 * macs)
    return b_ms, b_by, macs


def packed_layers(model, x: torch.Tensor, reps: int = 5) -> list:
    """Each slab conv (ConvOp) of one packed forward on `x`, timed alone
    (device_ms) on the slabs that forward fed it, beside its bound, the
    share of k32 x n16 blocks its tap masks keep, its live n16 pieces and
    its tap groups (packed_conv.launch_plan). Rows are keyed by conv name,
    as conv_layers' are."""
    from alpha_yolo_quant_torch.runtime import packed_conv as pc
    from alpha_yolo_quant_torch.runtime.interpreter import device_plan

    plan = device_plan(model, "cuda")
    calls = []
    kernel = pc.packed_call

    def recorder(x_slabs, taps, e, gp2, h_out, sig=None, qmax=127):
        calls.append((x_slabs, taps, e, gp2, h_out, sig, qmax))
        return kernel(x_slabs, taps, e, gp2, h_out, sig, qmax)

    pc.packed_call = recorder
    try:
        int_forward(model, plan, quantize_input(x, model.cfg.k),
                    head_requant=model.cfg.full_quant, engine="packed")
    finally:
        pc.packed_call = kernel
    names = {id(e): n for n, e in plan["slab_dev"][1].items()}
    rows = []
    for args in calls:
        x_slabs, taps, e, gp2, h_out = args[:5]
        out = kernel(*args)
        ms = device_ms(lambda: kernel(*args), reps)
        b_ms, b_by, macs = packed_bound(x_slabs, taps, e, out, h_out * gp2)
        rows.append({"conv": names[id(e)], "taps": len(taps),
                     "slabs": len(x_slabs), "rows": h_out * gp2,
                     "silu": e["silu"],
                     "kept_blocks": pc.kept_blocks(taps, e) / (32 * len(taps)),
                     "live_pieces": bin(e["live"]).count("1"),
                     "groups": len(pc.launch_plan(taps, e)["groups"]),
                     "ms": ms,
                     "useful_gmacs": macs / 1e9, "bound_ms": b_ms,
                     "bound_by": b_by})
    return rows


def conv_layers(model, x: torch.Tensor, reps: int = 5) -> list:
    """Each conv of one fused forward on `x`, timed alone (device_ms) on
    the activations the forward fed it: with its epilogue, and with the
    raw int32 one in place of the SiLU chain, beside its bound."""
    from alpha_yolo_quant_torch.runtime.interpreter import device_plan

    plan = device_plan(model, "cuda")
    names = {id(c): n for n, c in plan["convs"].items()}
    calls = []
    kernels = {"conv1x1": fused_ops.conv1x1, "conv3x3": fused_ops.conv3x3}

    def recorder(fn):
        def call(xi, c, sig=None, qmax=127):
            calls.append((names[id(c)], fn, xi, c))
            return fn(xi, c, sig, qmax)
        return call

    for k, fn in kernels.items():
        setattr(fused_ops, k, recorder(fn))
    try:
        int_forward(model, plan, quantize_input(x, model.cfg.k),
                    head_requant=model.cfg.full_quant)
    finally:
        for k, fn in kernels.items():
            setattr(fused_ops, k, fn)
    sig, qmax = plan["sig_lut"], model.cfg.qmax
    rows = []
    for name, fn, xi, c in calls:
        out = fn(xi, c, sig, qmax)
        ms = device_ms(lambda: fn(xi, c, sig, qmax), reps)
        raw = dict(c, silu=False)
        raw_ms = (device_ms(lambda: fn(xi, raw, sig, qmax), reps)
                  if c["silu"] else ms)
        consts = [c[f] for f in ("b", "r1", "s1", "r2", "s2") if f in c]
        macs = out.numel() * c["cin"] * c["kernel"] ** 2
        b_ms, b_by = bound(nbytes(xi, out, c["w_packed"], *consts),
                           2 * macs)
        rows.append({"conv": name, "shape": [*xi.shape, c["cout"],
                                             c["kernel"], c["stride"]],
                     "dtype": str(xi.dtype).replace("torch.", ""),
                     "silu": c["silu"], "ms": ms, "raw_epilogue_ms": raw_ms,
                     "bound_ms": b_ms, "bound_by": b_by})
    return rows


def _events_ms(fn):
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def _device_ms(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        if hasattr(evt, attr):
            return getattr(evt, attr) / 1e3
    return 0.0


def profile_engine(model, engine: str, x: torch.Tensor) -> dict:
    fn, plan = build_int_pipeline(model, "cuda", engine=engine)
    full = model.cfg.full_quant
    fn(x)                                   # warm-up: builds, caches
    torch.cuda.synchronize()
    _, wall = _events_ms(lambda: fn(x))
    xq, quant_ms = _events_ms(lambda: quantize_input(x, model.cfg.k))
    fused_ops.reset_counts()
    _, fwd_ms = _events_ms(lambda: int_forward(
        model, plan, xq, head_requant=full, engine=engine))
    launches = {k: v for k, v in fused_ops.LAUNCHES.items() if v}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn(x)
        torch.cuda.synchronize()
    by_kernel: dict = defaultdict(float)
    top = []
    for evt in prof.key_averages():
        ms = _device_ms(evt)
        if ms <= 0 or evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        label = next((v for k, v in PORT_KERNELS.items() if k in evt.key),
                     "torch ops")
        by_kernel[label] += ms
        top.append((ms, evt.key[:90], evt.count))
    top.sort(reverse=True)
    busy = sum(by_kernel.values())
    return {"engine": engine, "batch": int(x.shape[0]),
            "wall_ms": wall, "quantize_ms": quant_ms,
            "int_forward_ms": fwd_ms,
            "decode_nms_ms": wall - quant_ms - fwd_ms,
            "device_busy_ms": busy,
            "device_ms_by_kernel": dict(by_kernel),
            "forward_launches": launches,
            "top_kernels": [{"ms": m, "name": n, "calls": c}
                            for m, n, c in top[:8]]}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("engine_profile: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    model = build_model()
    s = model.cfg.image_size
    x = torch.as_tensor(np.random.default_rng(3).integers(
        0, 256, (BATCH, 3, s, s)).astype(np.uint8), device="cuda")
    for engine in ("fused", "pallas", "packed"):
        print(json.dumps(dict(profile_engine(model, engine, x), card=card)),
              flush=True)
    rows = conv_layers(model, x)
    print(json.dumps({"conv_layers": rows, "batch": BATCH, "card": card,
                      "sum_ms": sum(r["ms"] for r in rows),
                      "sum_raw_epilogue_ms": sum(r["raw_epilogue_ms"]
                                                 for r in rows),
                      "sum_bound_ms": sum(r["bound_ms"] for r in rows)}),
          flush=True)
    rows = packed_layers(model, x)
    print(json.dumps({"packed_layers": rows, "batch": BATCH, "card": card,
                      "sum_ms": sum(r["ms"] for r in rows),
                      "sum_bound_ms": sum(r["bound_ms"] for r in rows)}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
