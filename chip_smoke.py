"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # needs one CUDA card + nvcc

Phases (each one raises on failure; nothing falls back to the CPU):
  1. print the card's name and power limit; build the Hopper kernels from
     alpha_yolo_quant_torch/runtime/csrc and print the build seconds;
  2. hold every kernel against its plain PyTorch version on the card at
     shapes read from the yolov8n-640 graph IR (B=8), max|diff| must be 0,
     and time both with CUDA events;
  3. build a yolov8n K=8 full-quant 640 model with random weights from a
     seed, calibrated by the port's own float forward;
  4. serve three coalesced requests (4 uint8 + 8 f32 + 4 f32 images)
     through build_int_pipeline; every conv must launch a kernel, the
     detections must equal the plain path's bit for bit, and one image's
     head edges must equal the numpy int64 oracle golden_forward;
  5. time the whole pipeline at B=128;
then print the kernels line and, last, the device line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

KERNELS = {   # name -> (source in the repo, TPU kernel it replaces)
    "conv1x1": ("alpha_yolo_quant_torch/runtime/csrc/conv1x1.cu",
                "alpha_yolo_quant_tpu/runtime/pallas_ops.py:162"),
    "conv3x3": ("alpha_yolo_quant_torch/runtime/csrc/conv3x3.cu",
                "alpha_yolo_quant_tpu/runtime/pallas_ops.py:213"),
    "sigma_probe": ("alpha_yolo_quant_torch/runtime/csrc/sigma_probe.cu",
                    "alpha_yolo_quant_tpu/runtime/pallas_ops.py:108"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds per call, CUDA events around `reps` calls after
    a warm-up and a synchronize."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def edge_geometry(graph):
    """edge -> (channels, height) for a square input, walked over the IR."""
    from alpha_yolo_quant_tpu.models.graph import (
        ConcatNode, ConvNode, MaxPoolNode, ResidualAddNode, SplitNode,
        UpsampleNode,
    )

    geo = {graph.input_edge: (3, graph.cfg.image_size)}
    for n in graph.nodes:
        if isinstance(n, ConvNode):
            h = geo[n.src][1]
            geo[n.dst] = (n.cout, (h + 2 * n.padding - n.kernel) // n.stride
                          + 1)
        elif isinstance(n, SplitNode):
            c, h = geo[n.src]
            geo[n.dst1] = geo[n.dst2] = (c // 2, h)
        elif isinstance(n, ResidualAddNode):
            geo[n.dst] = geo[n.base]
        elif isinstance(n, ConcatNode):
            geo[n.dst] = (sum(geo[e][0] for e in n.srcs), geo[n.srcs[0]][1])
        elif isinstance(n, MaxPoolNode):
            geo[n.dst] = geo[n.src]
        elif isinstance(n, UpsampleNode):
            c, h = geo[n.src]
            geo[n.dst] = (c, h * n.factor)
    return geo


# (label, conv name in the yolov8n IR, wide int16 input, SiLU epilogue);
# the graph has no plain 3x3 conv, so two cases take a 3x3 layer's shape
# with the plain epilogue
KERNEL_CASES = [
    ("stem 3x3 s2 Cin=3", "Conv_P1", False, True),
    ("3x3 s1", "C2F_4_bottle_0", False, True),
    ("3x3 s2", "Conv_P3", False, True),
    ("3x3 s1 plain", "x_result_5_down_1", False, False),
    ("3x3 s2 plain", "Conv_P4", False, False),
    ("1x1 silu", "C2F_2_conv_1", False, True),
    ("1x1 plain box", "x_result_5_up_2", False, False),
    ("1x1 plain cls", "x_result_5_down_2", False, False),
    ("3x3 s1 wide int16", "C2F_4_bottle_2", True, True),
    ("1x1 silu wide int16", "C2F_4_conv_1", True, True),
]


def random_conv_case(node, hw: int, batch: int, wide: bool, silu: bool,
                     seed: int, device, qmax: int = 127):
    """Random int8 weights, int8 (or int16 |x| <= 3*qmax) NHWC input, and
    per-channel requant constants sized so the SiLU outputs spread over
    the int8 range; channel 0 takes shift 1 (shift-1 = 0)."""
    import torch

    from alpha_yolo_quant_torch.runtime import fused_ops

    rng = np.random.default_rng(seed)
    w = rng.integers(-qmax, qmax + 1,
                     (node.cout, node.cin, node.kernel, node.kernel))
    b = rng.integers(-2 ** 15, 2 ** 15, node.cout)
    amax = 3 * qmax if wide else qmax
    x = torch.as_tensor(
        rng.integers(-amax, amax + 1, (batch, hw, hw, node.cin)),
        dtype=torch.int16 if wide else torch.int8, device=device)
    c = fused_ops.conv_entry(w, b, node.stride, node.padding, False, device)
    if silu:
        acc = fused_ops.conv_acc_plain(x, c)
        rms = float(acc.to(torch.float64).pow(2).mean().sqrt()) + 1.0
        r1 = rng.integers(64, 256, node.cout)
        r2 = rng.integers(64, 256, node.cout)
        s1 = np.ceil(np.log2(r1 * rms / 48.0)).astype(np.int64) + 1
        s2 = np.ceil(np.log2(r2 * 64 * rms / 48.0)).astype(np.int64) + 1
        s1[0] = 1
        c = fused_ops.conv_entry(w, b, node.stride, node.padding, True,
                                 device, r1=r1, s1=np.maximum(s1, 1), r2=r2,
                                 s2=np.maximum(s2, 1))
    return x, c


def check_kernels(batch: int, image_size: int = 640, reps: int = 10):
    """Phase 2: every kernel against its plain version on the card.
    Returns {kernel name: {max_abs_err, ms, plain_ms, shape}} keeping the
    largest-work case of each kernel for the timings."""
    import torch

    from alpha_yolo_quant_tpu.config import QuantConfig
    from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
    from alpha_yolo_quant_tpu.quantize.luts import sigmoid_lut
    from alpha_yolo_quant_torch.ops.lut import DeviceLut
    from alpha_yolo_quant_torch.runtime import fused_ops

    dev = torch.device("cuda")
    graph = build_yolov8_graph(QuantConfig(model="yolov8n", k=8,
                                           full_quant=True,
                                           image_size=image_size))
    geo = edge_geometry(graph)
    sig = DeviceLut(sigmoid_lut(6.0, 8), dev)
    res = {}
    for i, (label, name, wide, silu) in enumerate(KERNEL_CASES):
        node = graph.conv_by_name(name)
        hw = geo[node.src][1]
        x, c = random_conv_case(node, hw, batch, wide, silu, seed=100 + i,
                                device=dev)
        kname = "conv1x1" if node.kernel == 1 else "conv3x3"
        wrapper = getattr(fused_ops, kname)
        got = wrapper(x, c, sig)
        want = fused_ops.conv_plain(x, c, sig, 127)
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{label}: kernel {tuple(got.shape)} "
                                 f"{got.dtype} vs plain "
                                 f"{tuple(want.shape)} {want.dtype}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        ms = cuda_ms(lambda: wrapper(x, c, sig), reps)
        plain_ms = cuda_ms(lambda: fused_ops.conv_plain(x, c, sig, 127),
                           max(2, reps // 5))
        macs = (x.shape[0] * got.shape[1] * got.shape[2] * node.cout
                * node.cin * node.kernel ** 2)
        shape = (f"B={batch} {node.cin}->{node.cout} {node.kernel}x"
                 f"{node.kernel} s{node.stride} {hw}px "
                 f"{'int16' if wide else 'int8'} "
                 f"{'silu' if silu else 'plain'}")
        spread = int(torch.unique(got).numel())
        log(f"kernel {kname} [{label}] {name} {shape}: max_abs_err={err} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
            f"GMAC/s={macs / ms / 1e6:.1f} distinct_out={spread}")
        if err != 0:
            raise AssertionError(f"{label}: kernel differs from plain by "
                                 f"{err}")
        r = res.setdefault(kname, {"max_abs_err": 0, "macs": -1})
        r["max_abs_err"] = max(r["max_abs_err"], err)
        if macs > r["macs"]:
            r.update(macs=macs, ms=ms, plain_ms=plain_ms, shape=shape)
    got = fused_ops.sigma_probe(sig)
    want = fused_ops.sigma_probe_plain(sig)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    corr = fused_ops.sigma_corrections(sig)
    ms = cuda_ms(lambda: fused_ops.sigma_probe(sig), 100)
    plain_ms = cuda_ms(lambda: fused_ops.sigma_probe_plain(sig), 100)
    log(f"kernel sigma_probe [255-entry sigmoid LUT]: max_abs_err={err} "
        f"corrections={corr} ms={ms:.4f} plain_ms={plain_ms:.4f}")
    if err != 0 or corr:
        raise AssertionError("sigma_probe differs from Lut.values")
    res["sigma_probe"] = {"max_abs_err": err, "ms": ms,
                          "plain_ms": plain_ms,
                          "shape": f"{sig.values.numel()} entries"}
    return res


def build_model(image_size: int, device):
    """Phase 3: yolov8n K=8 full-quant, random weights from seed 0,
    calibrated by the port's float forward on two seeded images."""
    from alpha_yolo_quant_tpu.config import QuantConfig
    from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
    from alpha_yolo_quant_tpu.models.params import init_params
    from alpha_yolo_quant_torch.quantize.calibrate import (
        collect_stats, reduce_stats,
    )
    from alpha_yolo_quant_torch.quantize.transform import (
        build_quantized_model,
    )

    cfg = QuantConfig(model="yolov8n", k=8, full_quant=True,
                      image_size=image_size)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=0)
    rng = np.random.default_rng(1)
    calib = rng.uniform(0, 1, (2, 3, image_size, image_size)).astype(
        np.float32)
    max_a = reduce_stats(collect_stats(graph, params, [calib], device),
                         "max", cfg.k)
    return build_quantized_model(graph, params, max_a, cfg)


def serve(model, device):
    """Phase 4: three coalesced requests through the kernel path, counted;
    then the same requests through the plain path on the card."""
    import torch

    from alpha_yolo_quant_torch.runtime import fused_ops
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline,
    )

    s = model.cfg.image_size
    rng = np.random.default_rng(2)
    reqs = [rng.integers(0, 256, (4, 3, s, s)).astype(np.uint8),
            rng.uniform(0, 1, (8, 3, s, s)).astype(np.float32),
            rng.uniform(0, 1, (4, 3, s, s)).astype(np.float32)]
    reqs = [torch.as_tensor(r, device=device) for r in reqs]
    torch.cuda.synchronize()
    fused_ops.reset_counts()
    fn, plan = build_int_pipeline(model, device, coalesce_requests=3)
    got = fn(*reqs)
    torch.cuda.synchronize()
    launches = dict(fused_ops.LAUNCHES)
    n_convs = len(model.graph.convs())
    conv_launches = launches["conv1x1"] + launches["conv3x3"]
    log(f"serve: 3 coalesced requests (4 uint8 + 8 f32 + 4 f32 images, "
        f"{s}px) -> launches {launches}; {conv_launches} conv launches "
        f"for {n_convs} convs in one forward")
    if conv_launches != n_convs or min(launches.values()) < 1:
        raise AssertionError("the serving path did not run every conv "
                             "through a kernel")
    plain_fn, _ = build_int_pipeline(model, device, coalesce_requests=3,
                                     plain=True)
    want = plain_fn(*reqs)
    torch.cuda.synchronize()
    total = 0
    for i, ((det, n), (det_p, n_p)) in enumerate(zip(got, want)):
        b = reqs[i].shape[0]
        if det.shape != (b, 300, 6) or n.shape != (b,):
            raise AssertionError(f"request {i}: shapes {tuple(det.shape)} "
                                 f"{tuple(n.shape)}")
        if not bool(torch.isfinite(det).all()) or int(n.max()) > 300:
            raise AssertionError(f"request {i}: non-finite detections")
        if not (torch.equal(det, det_p) and torch.equal(n, n_p)):
            raise AssertionError(f"request {i}: kernel path detections "
                                 "differ from the plain path")
        total += int(n.sum())
    log(f"serve: detections equal the plain path bit for bit "
        f"({total} detections over 16 images, all finite)")
    return launches, plan, reqs


def golden_heads(model, plan, x_u8):
    """Phase 4b: one image's six head edges from the kernel path against
    the numpy int64 oracle on the host."""
    import torch

    from alpha_yolo_quant_tpu.runtime.golden import golden_forward
    from alpha_yolo_quant_torch.runtime.interpreter import (
        int_forward, quantize_input,
    )

    outs = int_forward(model, plan, quantize_input(x_u8, model.cfg.k))
    x_f = (x_u8.to(torch.float32) / 255.0).cpu().numpy()
    t0 = time.perf_counter()
    env = golden_forward(model, x_f)
    sec = time.perf_counter() - t0
    for role in model.graph.outputs:
        if not np.array_equal(outs[role].cpu().numpy().astype(np.int64),
                              env[role]):
            raise AssertionError(f"head edge {role} differs from "
                                 "golden_forward")
    log(f"golden: the six head edges of one {model.cfg.image_size}px image "
        f"equal golden_forward (numpy int64 on the host, {sec:.1f} s)")


def time_pipeline(model, device, card: str, batch: int = 128,
                  reps: int = 3):
    """Phase 5: whole pipeline (uint8 images on the card -> detections)
    at B=128, host clock around synchronized batches after a warm-up."""
    import torch

    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline,
    )

    s = model.cfg.image_size
    x = torch.as_tensor(np.random.default_rng(3).integers(
        0, 256, (batch, 3, s, s)).astype(np.uint8), device=device)
    fn, _ = build_int_pipeline(model, device)
    fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        det, n = fn(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    fwd = cuda_ms(lambda: fn(x), 1, warmup=0)
    log(f"pipeline B={batch} {s}px yolov8n K=8 full-quant uint8 in -> "
        f"detections: {ms:.2f} ms/batch, {batch / ms * 1e3:.1f} img/s "
        f"(CUDA events: {fwd:.2f} ms) on {card}")
    return ms


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the card and has no CPU path")
    from alpha_yolo_quant_torch.runtime import _build

    dev = torch.device("cuda")
    card = card_line()
    log(card)
    _build.build()
    log(f"build: {_build.BUILD_INFO['seconds']:.1f} s for "
        f"{len(_build.SOURCES)} sources (sm_90a)")
    for name in _build.SOURCES:
        rep = _build.BUILD_INFO.get(f"ptxas_{name}", "")
        for ln in rep.splitlines():
            if "registers" in ln:
                log(f"ptxas {name}: {ln.strip()}")

    kres = check_kernels(batch=8)
    t0 = time.perf_counter()
    model = build_model(640, dev)
    log(f"model: yolov8n K=8 full-quant 640, random weights seed 0, "
        f"port calibration ({time.perf_counter() - t0:.1f} s)")
    launches, plan, reqs = serve(model, dev)
    golden_heads(model, plan, reqs[0][:1])
    time_pipeline(model, dev, card)
    log(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=KERNELS[k][0],
             replaces=KERNELS[k][1], launches=launches[k],
             max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], shape=r["shape"])
        for k, r in kres.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
