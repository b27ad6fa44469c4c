"""Drive the PyTorch port's serving paths on one CUDA card and check them.

    python3 chip_smoke.py            # needs one CUDA card + nvcc

Phases (each one raises on failure; nothing falls back to the CPU):
  1. print the card's name and power limit; build the Hopper kernels from
     alpha_yolo_quant_torch/runtime/csrc and print the build seconds;
     count the integer tensor-core (IGMMA/IMMA) and __dp4a/__dp2a (IDP)
     instructions in each library's SASS: the conv and slab-conv
     libraries must have tensor-core ones and no IDP;
  2. build a yolov8n K=8 full-quant 640 model with random weights from a
     seed, calibrated by the port's own float forward;
  3. hold every kernel against its plain PyTorch version on the card,
     max|diff| must be 0: conv1x1/conv3x3 on all 63 conv shapes of the
     graph at B=2 (int16 input on the wide edges); then time kernel and
     plain with CUDA events: the conv kernels at shapes read from the
     graph IR at B=8 and B=128, with torch._int_mm on the same int8
     product as the yardstick, the postconv epilogues on the nibble-split
     partials of a yolov8n conv at B=8 and B=128 (and the bytes of a
     whole pallas forward's epilogues), the banded slab conv on seven
     convs of the 640 model's slab plan at B=8 and B=128, with
     torch._int_mm on the gathered product of its taps as the yardstick;
  4. serve three coalesced requests (4 uint8 + 8 f32 + 4 f32 images)
     through build_int_pipeline on each engine (fused, pallas, packed),
     with the launch counts set to 0 just before each and read just after:
     every conv must go through the engine's kernels, and the detections
     must equal the plain path's bit for bit; one image's head edges must
     equal the numpy int64 oracle golden_forward, and its decoded planes
     golden's decode_full_quant_np;
  5. outside oracles at 640: two images' full-quant detections from the
     card equal the CPU pipeline's bit for bit; a partial-quant model (the
     float head on the card) serves two images whose head edges equal the
     CPU's and whose detections match the CPU pipeline within f32 rounding
     (counts and classes exact, boxes atol 1e-3, scores rtol 1e-5);
  6. the deployed path: the CLI's prepare from a synthetic torch
     checkpoint and its calibrate on the card, a full-quant model built
     from their files, then a BatchCoalescer (max_batch 128, 5 ms) fed
     24 uint8 requests from 8 threads, counted: 63 conv launches per
     flush, and every request's detections equal a direct pipeline call;
     prints the coalescer's snapshot;
  7. time the whole pipeline of each engine at B=128;
  8. quantize -> export -> load back -> serve: the phase-2 model's
     artifact tree exported by export_all with the golden run of one
     64-px image (the weights, scales and max_a in the tree do not depend
     on the image size; a 640 golden image makes a tree of GBs of text),
     loaded back at 640 by model_from_artifacts and by
     model_from_packed_state_dict, each served on every engine: launch
     counts as in phase 4, detections equal to the directly built model's
     on the same engine bit for bit; prints the tree's files and bytes,
     the export seconds and whether the native Verilog writer was built
     (g++) or the Python writers ran;
  9. the eval harness on the card: 32 seeded uint8 images at 640 as a
     COCO set whose annotations are the CPU pipeline's full-quant
     detections, jittered and thinned by a seed (so the mAP is neither 0
     nor 1); evaluate with the fused full-quant pipeline on the card at a
     batch that leaves a padded tail: its rows equal the CPU pipeline's
     and those of the same run with prefetch=True (batches staged on the
     card from pinned memory), its mAP50-95 the CPU run's and the loop
     oracle's on the same rows;
 10. the conf-first sparse decode, the bench, the profiler and hwsim:
     (a) phase 4's three requests through build_int_pipeline(
     sparse_select=True) on each engine, counted: detections and launches
     equal phase 4's dense run's; then B=128 uint8 fused dense and sparse
     timed in turns (dense, sparse, sparse, dense); (b) the port's bench
     (bench.main) for fused f32 and u8, pallas u8, packed u8 and fused
     with two coalesced requests of 64, each counted (its engine's
     kernels must launch), its JSON line printed; (c) one B=8 fused batch
     inside profiling.device_trace, whose chrome trace must hold the conv
     kernels' device events; (d) the CLI's info, memsim and memsim
     --min-buffer at 640 (host only): peak 2,867,200 cells, the reference
     buffer, and final_memory.txt written; prints the phase's seconds;
 11. parallel/{mesh, pipeline} (parallel_phase): (a) NCCL over the visible
     cards (at most 4; one here): the dp step serves phase 4's requests
     equal to phase 4, the all-reduced calibration taps equal one rank's,
     and the CLI's calibrate --dp writes phase 6's max_a.txt byte for
     byte; (b) four gloo ranks sharing cuda:0: dp=2, pp S=2 and S=4 (conv
     launches 63 per microbatch over the stages), sp=2, sp=4 and dp x sp
     equal the unsharded fused run bit for bit, tp=2 float preds within
     rtol 1e-4; prints the backends, world sizes and seconds;
then print the kernels line (every kernel with its launches on its path,
error, times and bound; sigma_probe also with the launch floor, an empty
kernel's device time) and, last, the device line.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

_PALLAS = "alpha_yolo_quant_tpu/runtime/pallas_ops.py"
KERNELS = {   # name -> (source in the repo, TPU kernel it replaces)
    "conv1x1": ("alpha_yolo_quant_torch/runtime/csrc/conv1x1.cu",
                f"{_PALLAS}:162"),
    "conv3x3": ("alpha_yolo_quant_torch/runtime/csrc/conv3x3.cu",
                f"{_PALLAS}:213"),
    "sigma_probe": ("alpha_yolo_quant_torch/runtime/csrc/sigma_probe.cu",
                    f"{_PALLAS}:108"),
    "postconv_silu": ("alpha_yolo_quant_torch/runtime/csrc/postconv.cu",
                      f"{_PALLAS}:73"),
    "postconv_plain": ("alpha_yolo_quant_torch/runtime/csrc/postconv.cu",
                       f"{_PALLAS}:244"),
    "packed_conv": ("alpha_yolo_quant_torch/runtime/csrc/packed_conv.cu",
                    "alpha_yolo_quant_tpu/runtime/packed_conv.py:299"),
}
ENGINE_KERNELS = {   # kernels each serving engine launches
    "fused": ("conv1x1", "conv3x3", "sigma_probe"),
    "pallas": ("postconv_silu", "postconv_plain"),
    "packed": ("packed_conv",),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def max_err(got, want, label: str) -> int:
    import torch

    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{label}: kernel {tuple(got.shape)} "
                             f"{got.dtype} vs plain {tuple(want.shape)} "
                             f"{want.dtype}")
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    if err != 0:
        raise AssertionError(f"{label}: kernel differs from plain by {err}")
    return err


def edge_geometry(graph):
    """edge -> (channels, height) for a square input, walked over the IR."""
    from alpha_yolo_quant_torch.models.graph import (
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
    ("3x3 s1 head 80->80", "x_result_5_down_1", False, True),
    ("3x3 s1 128->128", "C2F_8_bottle_0", False, True),
]
CONV_LIBS = ("conv1x1", "conv3x3", "packed_conv")   # tensor-core kernels
# (kernel, conv name): the postconv epilogues on the partials of a conv
POSTCONV_CASES = [("postconv_silu", "Conv_P1"),
                  ("postconv_plain", "x_result_5_down_2")]


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


def keep_case(res: dict, name: str, work: float, **fields) -> None:
    """Keep, per kernel, the largest-work case for the kernels line."""
    r = res.setdefault(name, {"max_abs_err": 0, "work": -1.0})
    r["max_abs_err"] = max(r["max_abs_err"], fields["max_abs_err"])
    if work > r["work"]:
        r.update(fields, work=work)


def check_tensor_cores() -> None:
    """Phase 1b: integer tensor-core (IGMMA, IMMA) and dot-product (IDP.4A
    = __dp4a, IDP.2A = __dp2a) instructions in each library's SASS
    (cuobjdump -sass); fails if a conv library has no tensor-core one or
    any dot-product one."""
    from alpha_yolo_quant_torch.runtime import _build

    tool = _build.cuda_tool("cuobjdump")
    for name in _build.SOURCES:
        sass = subprocess.run([tool, "-sass", str(_build.targets()[name])],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        n = {op: len(re.findall(rf"\b{re.escape(op)}\.", sass))
             for op in ("IGMMA", "IMMA", "IDP.4A", "IDP.2A")}
        log(f"sass {name}: " + " ".join(f"{k}={v}" for k, v in n.items()))
        if name in CONV_LIBS and (n["IGMMA"] + n["IMMA"] == 0
                                  or n["IDP.4A"] + n["IDP.2A"] > 0):
            raise AssertionError(f"{name}: its SASS has no integer "
                                 "tensor-core instruction, or a __dp4a")


def check_every_conv_shape(model, sig, batch: int = 2) -> None:
    """Phase 3a: conv1x1/conv3x3 against conv_plain on every conv of the
    graph at its own shape, int16 input where the model marks the input
    edge wide (edge_amax_int > 127)."""
    from alpha_yolo_quant_torch.runtime import fused_ops

    geo = edge_geometry(model.graph)
    convs = model.graph.convs()
    wide = []
    t0 = time.perf_counter()
    for i, node in enumerate(convs):
        is_wide = model.edge_amax_int.get(node.src, 0) > 127
        x, c = random_conv_case(node, geo[node.src][1], batch, is_wide,
                                node.silu, seed=300 + i,
                                device=sig.values.device)
        wrapper = (fused_ops.conv1x1 if node.kernel == 1
                   else fused_ops.conv3x3)
        max_err(wrapper(x, c, sig), fused_ops.conv_plain(x, c, sig, 127),
                f"{node.name} {node.cin}->{node.cout} k{node.kernel} "
                f"s{node.stride}")
        if is_wide:
            wide.append(node.name)
    log(f"kernel conv1x1/conv3x3: all {len(convs)} conv shapes of the "
        f"{model.cfg.image_size}px graph at B={batch} equal conv_plain "
        f"(max_abs_err=0; int16 input on the {len(wide)} wide edges: "
        f"{', '.join(wide)}) in {time.perf_counter() - t0:.1f} s")


def check_conv_kernels(graph, sig, res, batch: int, reps: int):
    """conv1x1 and conv3x3 against conv_plain at yolov8n-640 shapes, and
    torch._int_mm on the same int8 product (for a 3x3, the unfolded
    (B*Ho*Wo, 9*Cin) x (9*Cin, Cout) one, the unfold not timed) as the
    library yardstick."""
    from alpha_yolo_quant_torch.engine_profile import bound, device_ms, nbytes
    import torch

    from alpha_yolo_quant_torch.runtime import fused_ops

    dev = sig.values.device
    geo = edge_geometry(graph)
    for i, (label, name, wide, silu) in enumerate(KERNEL_CASES):
        node = graph.conv_by_name(name)
        hw = geo[node.src][1]
        x, c = random_conv_case(node, hw, batch, wide, silu, seed=100 + i,
                                device=dev)
        kname = "conv1x1" if node.kernel == 1 else "conv3x3"
        wrapper = getattr(fused_ops, kname)
        got = wrapper(x, c, sig)
        err = max_err(got, fused_ops.conv_plain(x, c, sig, 127), label)
        ms = device_ms(lambda: wrapper(x, c, sig), reps)
        host_ms = device_ms(lambda: wrapper(x, c, sig), reps, spin=False)
        plain_ms = device_ms(lambda: fused_ops.conv_plain(x, c, sig, 127),
                           max(2, reps // 5))
        macs = (x.shape[0] * got.shape[1] * got.shape[2] * node.cout
                * node.cin * node.kernel ** 2)
        consts = [c[f] for f in ("b", "r1", "s1", "r2", "s2") if f in c]
        bound_ms, bound_by = bound(
            nbytes(x, got, *consts) + c["w_f64"].numel(), 2 * macs)
        m_rows = got.shape[0] * got.shape[1] * got.shape[2]
        depth = node.cin * node.kernel ** 2
        k_mm = -(-depth // 8) * 8    # _int_mm takes a depth divisible by 8
        a8 = torch.randint(-127, 128, (m_rows, k_mm), dtype=torch.int8,
                           device=dev)
        w8 = torch.randint(-127, 128, (k_mm, node.cout), dtype=torch.int8,
                           device=dev)
        lib_ms = device_ms(lambda: torch._int_mm(a8, w8), reps)
        del a8, w8
        shape = (f"B={batch} {node.cin}->{node.cout} {node.kernel}x"
                 f"{node.kernel} s{node.stride} {hw}px "
                 f"{'int16' if wide else 'int8'} "
                 f"{'silu' if silu else 'plain'}")
        lib = (f" _int_mm_ms={lib_ms:.4f} ({m_rows}x{k_mm}x{node.cout}"
               f"{'' if node.kernel == 1 else ', unfold not timed'}"
               f"{f', depth {depth} padded' if k_mm != depth else ''})")
        log(f"kernel {kname} [{label}] {name} {shape}: max_abs_err={err} "
            f"ms={ms:.4f} (host in the loop: {host_ms:.4f}) "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f}"
            f"{lib} GMAC/s={macs / ms / 1e6:.1f} "
            f"distinct_out={int(torch.unique(got).numel())}")
        keep_case(res, kname, macs, max_abs_err=err, ms=ms,
                  plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                  library_ms=lib_ms, shape=shape)


def check_postconv_kernels(graph, sig, res, batch: int, reps: int):
    """postconv_silu/plain on the real nibble-split partials of a yolov8n
    conv (NHWC, channel axis 3), against their plain versions and against
    the whole conv's plain version."""
    from alpha_yolo_quant_torch.engine_profile import bound, device_ms, nbytes
    from alpha_yolo_quant_torch.ops.nn import conv2d_int_parts
    from alpha_yolo_quant_torch.runtime import fused_ops

    geo = edge_geometry(graph)
    for i, (kname, name) in enumerate(POSTCONV_CASES):
        node = graph.conv_by_name(name)
        silu = kname == "postconv_silu"
        hw = geo[node.src][1]
        x, c = random_conv_case(node, hw, batch, False, silu, seed=200 + i,
                                device=sig.values.device)
        hi, lo = conv2d_int_parts(x, c)
        consts = ((c["b"], c["r1"], c["s1"], c["r2"], c["s2"]) if silu
                  else (c["b"],))
        if silu:
            def run():
                return fused_ops.postconv_silu(hi, lo, *consts, sig,
                                               axis=3)

            def run_plain():
                return fused_ops.postconv_silu_plain(hi, lo, *consts, sig,
                                                     axis=3)
        else:
            def run():
                return fused_ops.postconv_plain(hi, lo, c["b"], axis=3)

            def run_plain():
                return fused_ops.postconv_plain_plain(hi, lo, c["b"],
                                                      axis=3)
        got = run()
        err = max_err(got, run_plain(), kname)
        max_err(got, fused_ops.conv_plain(x, c, sig, 127),
                f"{kname} against the whole plain conv")
        ms = device_ms(run, reps)
        plain_ms = device_ms(run_plain, max(2, reps // 5))
        bound_ms, bound_by = bound(nbytes(hi, lo, got, *consts), 0)
        shape = (f"B={batch} {node.cout}ch {geo[node.dst][1]}px NHWC "
                 f"(partials of {name})")
        log(f"kernel {kname} {shape}: max_abs_err={err} ms={ms:.4f} "
            f"plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
            f"GB/s={nbytes(hi, lo, got) / ms / 1e6:.1f}")
        keep_case(res, kname, hi.numel(), max_abs_err=err, ms=ms,
                  plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                  library_ms=None, shape=shape)


def postconv_forward_bound(graph, batch: int = 128) -> None:
    """The bytes the postconv epilogues of one pallas forward must move,
    from the graph IR: each SiLU conv reads two int32 partials and writes
    int8 (9 bytes an output), each plain conv writes int32 (12 bytes),
    over the card's memory rate."""
    from alpha_yolo_quant_torch.engine_profile import HBM_BPS

    geo = edge_geometry(graph)
    outs = {True: 0, False: 0}
    for n in graph.convs():
        outs[n.silu] += batch * geo[n.dst][1] ** 2 * n.cout
    n_bytes = 9 * outs[True] + 12 * outs[False]
    log(f"postconv B={batch} pallas forward: "
        f"{sum(n.silu for n in graph.convs())} SiLU convs "
        f"{outs[True] / 1e9:.3f} G int8 outputs (9 bytes each) + "
        f"{sum(not n.silu for n in graph.convs())} plain convs "
        f"{outs[False] / 1e9:.3f} G int32 outputs (12 bytes each) = "
        f"{n_bytes / 1e9:.2f} GB, bound {n_bytes / HBM_BPS * 1e3:.2f} ms")


DERIVED = ("s2e:", "s2o:", "eoe:", "eoo:")   # row/group views of a slab


def packed_cases(sp, live):
    """Seven ConvOps of the slab plan: (label, op, silu). ``live(op)`` is
    the op's live-piece mask. Fails if the plan lacks one of the kinds."""
    def keys(op):
        return {k for k, _, _ in op.taps}

    ops = [op for v in sp.node_ops.values() for op in v
           if type(op).__name__ == "ConvOp"]
    kinds = [
        ("s1 9 taps", lambda o: len(o.taps) == 9 and len(keys(o)) == 1
         and not next(iter(keys(o))).startswith(DERIVED)),
        ("s2 (s2e/s2o)",
         lambda o: any(k.startswith(DERIVED[:2]) for k in keys(o))),
        ("down2 (eoe/eoo)",
         lambda o: any(k.startswith(DERIVED[2:]) for k in keys(o))),
        ("18 taps two slabs (wide)",
         lambda o: len(o.taps) == 18 and len(keys(o)) == 2),
        ("3-slab concat consumer", lambda o: len(keys(o)) == 3),
        ("dead n16 pieces, c_slot 128",
         lambda o: o.geom.c_slot == 128 and live(o) != 255),
    ]
    cases = []
    for label, pred in kinds:
        hit = [o for o in ops if pred(o)]
        if not hit:
            raise AssertionError(f"the slab plan has no {label} conv")
        cases.append((label, max(hit, key=lambda o: o.h_out * o.geom.gp2),
                      True))
    cases.append(("raw int32 (s1 9 taps)", cases[0][1], False))
    return cases


def check_packed_kernel(model, plan, res, batch: int, reps: int):
    """packed_conv on seven convs of the 640 slab plan, random int8 input
    slabs in each conv's geometry, against packed_call_plain; torch._int_mm
    on the gathered (B*m, T*128) x (T*128, 128) product of the same taps
    (the gather not timed) as the library yardstick."""
    from alpha_yolo_quant_torch.engine_profile import (
        device_ms, packed_bound,
    )
    import torch

    from alpha_yolo_quant_torch.runtime import packed_conv as pc
    from alpha_yolo_quant_torch.runtime.interpreter import slab_plan
    from alpha_yolo_quant_torch.runtime.slabforward import SlabExec

    sp = slab_plan(model, plan)
    sig = plan["sig_lut"]
    gen = torch.Generator(device=plan["device"]).manual_seed(7)
    ex0 = SlabExec(sp, model, plan, {}, model.cfg.qmax)
    for label, op, silu in packed_cases(sp, lambda o: ex0.entry(o)["live"]):
        ex = SlabExec(sp, model, plan, {}, model.cfg.qmax)
        for k, _, _ in op.taps:
            base = k.split(":", 1)[1] if k.startswith(DERIVED) else k
            if base not in ex.slabs:
                ex.slabs[base] = torch.randint(
                    -127, 128, (batch, sp.geoms[base].rows_ext, 128),
                    generator=gen, dtype=torch.int8, device=plan["device"])
        x_slabs, taps = ex.conv_inputs(op)
        e = dict(ex.entry(op), silu=silu)
        args = (x_slabs, taps, e, op.geom.gp2, op.h_out, sig)
        got = pc.packed_call(*args)
        err = max_err(got, pc.packed_call_plain(*args), label)
        ms = device_ms(lambda: pc.packed_call(*args), reps)
        plain_ms = device_ms(lambda: pc.packed_call_plain(*args),
                           max(2, reps // 5))
        m = op.h_out * op.geom.gp2
        a8 = torch.cat([x_slabs[si][:, base:base + m] for si, _, base in taps],
                       dim=2).reshape(batch * m, 128 * len(taps))
        w8 = e["w_f64"][[t for _, t, _ in taps]].reshape(
            128 * len(taps), 128).to(torch.int8)
        lib_ms = device_ms(lambda: torch._int_mm(a8, w8), reps)
        del a8, w8
        bound_ms, bound_by, macs = packed_bound(x_slabs, taps, e, got, m)
        kept = pc.kept_blocks(taps, e) / (32 * len(taps))
        g = op.geom
        shape = (f"B={batch} {op.name} {len(taps)} taps over "
                 f"{len(x_slabs)} slabs, c_slot {g.c_slot} p={g.p} "
                 f"{g.h}px m={m} {'silu int8' if silu else 'raw int32'}")
        log(f"kernel packed_conv [{label}] {shape}: max_abs_err={err} "
            f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={bound_ms:.4f} "
            f"_int_mm_ms={lib_ms:.4f} ({batch * m}x{128 * len(taps)}x128, "
            f"gather not timed) kept_blocks={kept:.3f} "
            f"live_pieces={bin(e['live']).count('1')}/8 "
            f"useful GMAC/s={macs / ms / 1e6:.1f}")
        keep_case(res, "packed_conv", macs, max_abs_err=err, ms=ms,
                  plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                  library_ms=lib_ms, shape=shape)


def check_kernels(model, plan, batch: int, reps: int = 10):
    """Phase 3: every kernel against its plain version on the card.
    Returns {kernel name: the fields of its kernels-line entry}."""
    from alpha_yolo_quant_torch.engine_profile import bound, device_ms, nbytes
    from alpha_yolo_quant_torch.runtime import fused_ops

    res: dict = {}
    graph, sig = model.graph, plan["sig_lut"]
    check_every_conv_shape(model, sig)
    for b in (batch, 128):
        check_conv_kernels(graph, sig, res, b, reps)
    got = fused_ops.sigma_probe(sig)
    err = max_err(got, fused_ops.sigma_probe_plain(sig), "sigma_probe")
    corr = fused_ops.sigma_corrections(sig)
    ms = device_ms(lambda: fused_ops.sigma_probe(sig), 100)
    plain_ms = device_ms(lambda: fused_ops.sigma_probe_plain(sig), 100)
    bound_ms, bound_by = bound(nbytes(sig.values, got), 0)
    log(f"kernel sigma_probe [255-entry sigmoid LUT]: max_abs_err={err} "
        f"corrections={corr} ms={ms:.4f} plain_ms={plain_ms:.4f} "
        f"bound_ms={bound_ms:.6f}")
    if corr:
        raise AssertionError("sigma_probe differs from Lut.values")
    keep_case(res, "sigma_probe", 0, max_abs_err=err, ms=ms,
              plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
              library_ms=None, shape=f"{sig.values.numel()} entries")
    for b in (batch, 128):
        check_postconv_kernels(graph, sig, res, b, reps)
    postconv_forward_bound(graph)
    for b in (batch, 128):
        check_packed_kernel(model, plan, res, b, reps)
    return res


def expected_launches(model, engine: str, n_slab: int) -> dict:
    """The launches one forward must make on each engine."""
    convs = model.graph.convs()
    n_silu = sum(1 for n in convs if n.silu)
    if engine == "pallas":   # two partial convs per conv, then an epilogue
        return {"conv": 2 * len(convs), "postconv_silu": n_silu,
                "postconv_plain": len(convs) - n_silu}
    if engine == "packed":
        return {"conv": len(convs) - n_slab, "packed_conv": n_slab}
    return {"conv": len(convs)}


def serve(model, device):
    """Phase 4: three coalesced requests through each engine, counted;
    the detections against the plain path on the card."""
    import torch

    from alpha_yolo_quant_torch.runtime import fused_ops
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline, slab_plan,
    )

    s = model.cfg.image_size
    rng = np.random.default_rng(2)
    reqs = [rng.integers(0, 256, (4, 3, s, s)).astype(np.uint8),
            rng.uniform(0, 1, (8, 3, s, s)).astype(np.float32),
            rng.uniform(0, 1, (4, 3, s, s)).astype(np.float32)]
    reqs = [torch.as_tensor(r, device=device) for r in reqs]
    plain_fn, _ = build_int_pipeline(model, device, coalesce_requests=3,
                                     plain=True)
    want = plain_fn(*reqs)
    torch.cuda.synchronize()
    launches, plans, per_engine = {}, {}, {}
    for engine in ("fused", "pallas", "packed"):
        torch.cuda.synchronize()
        fused_ops.reset_counts()
        fn, plan = build_int_pipeline(model, device, coalesce_requests=3,
                                      engine=engine)
        got = fn(*reqs)
        torch.cuda.synchronize()
        counts = dict(fused_ops.LAUNCHES)
        n_slab = slab_plan(model, plan).n_convs if engine == "packed" else 0
        exp = expected_launches(model, engine, n_slab)
        seen = {"conv": counts["conv1x1"] + counts["conv3x3"],
                **{k: counts[k] for k in exp if k != "conv"}}
        log(f"serve [{engine}]: 3 coalesced requests (4 uint8 + 8 f32 + 4 "
            f"f32 images, {s}px) -> launches {counts}; expected per "
            f"forward {exp}")
        if seen != exp or min(counts[k] for k in
                              ENGINE_KERNELS[engine]) < 1:
            raise AssertionError(f"{engine}: the serving path did not run "
                                 f"every conv through its kernels")
        total = 0
        for i, ((det, n), (det_p, n_p)) in enumerate(zip(got, want)):
            b = reqs[i].shape[0]
            if det.shape != (b, 300, 6) or n.shape != (b,):
                raise AssertionError(f"{engine} request {i}: shapes "
                                     f"{tuple(det.shape)} {tuple(n.shape)}")
            if not bool(torch.isfinite(det).all()) or int(n.max()) > 300:
                raise AssertionError(f"{engine} request {i}: non-finite "
                                     "detections")
            if not (torch.equal(det, det_p) and torch.equal(n, n_p)):
                raise AssertionError(f"{engine} request {i}: detections "
                                     "differ from the plain path")
            total += int(n.sum())
        log(f"serve [{engine}]: detections equal the plain path (and so "
            f"every other engine) bit for bit ({total} detections over 16 "
            f"images, all finite)")
        launches.update({k: counts[k] for k in ENGINE_KERNELS[engine]})
        plans[engine] = plan
        per_engine[engine] = counts
    return launches, plans, reqs, want, per_engine


def golden_heads(model, plan, x_u8):
    """Phase 4b: one image's six head edges from the kernel path against
    the numpy int64 oracle on the host, and its decoded (1, 84, 8400)
    planes (boxes in anchor units, 16-bit class sigmoid) against golden's
    float64 decode_full_quant_np, exactly: the f32 boxes are sums of
    integers below 2^24 times power-of-two strides."""
    import torch

    from alpha_yolo_quant_torch.runtime.golden import (
        decode_full_quant_np, golden_forward,
    )
    from alpha_yolo_quant_torch.runtime.interpreter import (
        decode_full_quant, int_forward, quantize_input,
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
    plane = decode_full_quant(model, plan, outs).cpu().numpy()
    want = decode_full_quant_np(model, env)
    if plane.shape != want.shape or not np.array_equal(
            plane.astype(np.float64), want):
        raise AssertionError("decoded planes differ from "
                             "decode_full_quant_np")
    log(f"golden: the decoded planes {tuple(plane.shape)} from the card "
        f"equal decode_full_quant_np (max_abs_err=0)")


def check_against_cpu(model, device, image_size: int = 640):
    """Phase 5a: two uint8 images' full-quant detections from the fused
    engine on the card against the CPU pipeline (plain convs), bit for
    bit: 8400 anchors, the top-1000 q_NMS regime."""
    import torch

    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline,
    )

    x = np.random.default_rng(5).integers(
        0, 256, (2, 3, image_size, image_size)).astype(np.uint8)
    det, n = build_int_pipeline(model, device)[0](
        torch.as_tensor(x, device=device))
    det_c, n_c = build_int_pipeline(model, "cpu", plain=True)[0](x)
    if not (torch.equal(det.cpu(), det_c) and torch.equal(n.cpu(), n_c)):
        raise AssertionError("full-quant detections on the card differ "
                             "from the CPU pipeline")
    log(f"cpu oracle [full quant]: 2 images {image_size}px, "
        f"{int(n_c.sum())} detections from the card equal the CPU "
        f"pipeline bit for bit")


def check_partial_quant(device, image_size: int = 640):
    """Phase 5b: a partial-quant model (same weights and calibration, the
    float head on the card): two images through the fused engine; the
    head edges equal the CPU's bit for bit, the detections match the CPU
    pipeline with counts and classes exact, boxes within atol 1e-3 and
    scores within rtol 1e-5."""
    import torch

    from alpha_yolo_quant_torch.engine_profile import build_model
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline, device_plan, int_forward, quantize_input,
    )

    model = build_model(image_size, device, full_quant=False)
    dfl = np.arange(16, dtype=np.float32)    # init_params' DFL weight
    x = np.random.default_rng(6).integers(
        0, 256, (2, 3, image_size, image_size)).astype(np.uint8)
    xt = torch.as_tensor(x, device=device)
    outs = int_forward(model, device_plan(model, device),
                       quantize_input(xt, model.cfg.k))
    outs_c = int_forward(model, device_plan(model, "cpu"),
                         quantize_input(torch.as_tensor(x), model.cfg.k),
                         plain=True)
    for role in model.graph.outputs:
        if not torch.equal(outs[role].cpu(), outs_c[role]):
            raise AssertionError(f"partial quant: head edge {role} "
                                 "differs from the CPU")
    det, n = build_int_pipeline(model, device, dfl_w_float=dfl)[0](xt)
    det_c, n_c = build_int_pipeline(model, "cpu", dfl_w_float=dfl,
                                    plain=True)[0](x)
    det, n = det.cpu().numpy(), n.cpu().numpy()
    det_c, n_c = det_c.numpy(), n_c.numpy()
    if not np.array_equal(n, n_c) or not np.array_equal(det[..., 5],
                                                        det_c[..., 5]):
        raise AssertionError(f"partial quant: counts {n} vs CPU {n_c} or "
                             "classes differ")
    box_err = float(np.abs(det[..., :4] - det_c[..., :4]).max())
    score_rel = float((np.abs(det[..., 4] - det_c[..., 4])
                       / np.maximum(np.abs(det_c[..., 4]), 1e-30)).max())
    np.testing.assert_allclose(det[..., :4], det_c[..., :4], atol=1e-3)
    np.testing.assert_allclose(det[..., 4], det_c[..., 4], rtol=1e-5)
    log(f"cpu oracle [partial quant]: 2 images {image_size}px, head edges "
        f"equal the CPU's; {int(n_c.sum())} detections, counts and classes "
        f"exact, max box diff {box_err:.3g} px (atol 1e-3), max score "
        f"rel diff {score_rel:.3g} (rtol 1e-5)")


def synthetic_checkpoint(graph, path: str, seed: int = 0) -> int:
    """torch.save init_raw_params(seed) as a state dict in the checkpoint's
    slot (registration) order under opaque names, like an ultralytics
    checkpoint; returns the tensor count."""
    from collections import OrderedDict

    import torch

    from alpha_yolo_quant_torch.models.params import (
        init_raw_params, raw_param_slots,
    )

    raw = init_raw_params(graph, seed=seed)
    sd = OrderedDict()
    for key, fields in raw_param_slots(graph):
        for f in fields:
            sd[f"model.model.{len(sd)}.t"] = torch.from_numpy(
                np.array(raw[key][f]))
    torch.save(sd, path)
    return len(sd)


def deployed_path(device, card: str, image_size: int = 640,
                  n_requests: int = 24, n_threads: int = 8):
    """Phase 6: prepare -> calibrate -> serve as a deployment runs it. The
    CLI's prepare and calibrate (synthetic batches of 8 images, on the
    card) write their files in a temp dir; a full-quant model is built
    from them; a BatchCoalescer (max_batch 128, max_wait 5 ms) serves
    uint8 requests of 1-16 images from several threads. Fails unless the
    fused engine launched 63 convs per flush and every request's
    detections equal a direct call of the same pipeline. Returns the
    coalescer's snapshot and the bytes of the fused weights and max_a.txt
    that prepare and calibrate wrote."""
    import tempfile
    import threading

    import torch

    from alpha_yolo_quant_torch import cli
    from alpha_yolo_quant_torch.config import QuantConfig
    from alpha_yolo_quant_torch.models.graph import build_yolov8_graph
    from alpha_yolo_quant_torch.quantize.transform import (
        build_quantized_model,
    )
    from alpha_yolo_quant_torch.runtime import fused_ops
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline,
    )
    from alpha_yolo_quant_torch.serving import BatchCoalescer
    from alpha_yolo_quant_torch.utils.io import read_max_a
    from alpha_yolo_quant_torch.utils.params_io import load_params

    cfg = QuantConfig(model="yolov8n", k=8, full_quant=True,
                      image_size=image_size)
    graph = build_yolov8_graph(cfg)
    size = ["--image-size", str(image_size)]
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "yolov8n_synthetic.pt")
        n_tensors = synthetic_checkpoint(graph, ckpt)
        out = os.path.join(tmp, "8_nano")
        t0 = time.perf_counter()
        if cli.main(["prepare", "--checkpoint", ckpt, "--out", out]
                    + size) != 0:
            raise AssertionError("prepare failed")
        t1 = time.perf_counter()
        npz = os.path.join(out, "results", "weights_batchnf.npz")
        if cli.main(["calibrate", "--weights", npz, "--out", out,
                     "--device", str(device)] + size) != 0:
            raise AssertionError("calibrate failed")
        t2 = time.perf_counter()
        params = load_params(npz)
        max_a = read_max_a(os.path.join(out, "results", "max_a.txt"))
        with open(npz, "rb") as f_npz, open(os.path.join(
                out, "results", "max_a.txt"), "rb") as f_max_a:
            files = {"npz": f_npz.read(), "max_a": f_max_a.read()}
    model = build_quantized_model(graph, params, max_a, cfg)
    fn, _ = build_int_pipeline(model, device)
    log(f"deployed: prepare ({n_tensors}-tensor synthetic checkpoint, "
        f"{t1 - t0:.1f} s) -> calibrate (8 synthetic images on the card, "
        f"{t2 - t1:.1f} s) -> a full-quant model from {len(max_a)} max_a "
        f"entries")
    rng = np.random.default_rng(4)
    shape = (3, image_size, image_size)
    reqs = [rng.integers(0, 256, (int(rng.integers(1, 17)),) + shape,
                         dtype=np.uint8) for _ in range(n_requests)]
    results, errors = [None] * n_requests, []
    torch.cuda.synchronize()
    fused_ops.reset_counts()
    with BatchCoalescer(fn, max_batch=128, max_wait_ms=5,
                        image_shape=shape, dtype=np.uint8) as co:
        def submitter(t):
            try:
                for i in range(t, n_requests, n_threads):
                    results[i] = co.submit(reqs[i]).result(timeout=600)
            except BaseException as e:   # re-raised by the main thread
                errors.append(e)

        threads = [threading.Thread(target=submitter, args=(t,))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a submitter did not finish")
        if errors:
            raise errors[0]
        stats = co.snapshot()
    torch.cuda.synchronize()
    counts = dict(fused_ops.LAUNCHES)
    n_conv = counts["conv1x1"] + counts["conv3x3"]
    per_flush = len(graph.convs())
    log(f"deployed: launches {counts} over {stats['flushes']} flushes")
    if (stats["requests"] != n_requests or stats["flushes"] < 1
            or n_conv != per_flush * stats["flushes"]):
        raise AssertionError(f"deployed path: {n_conv} conv launches for "
                             f"{stats['flushes']} flushes, expected "
                             f"{per_flush} per flush")
    total = 0
    for r, (det, n) in zip(reqs, results):
        det_d, n_d = fn(r)
        if not (np.array_equal(det, det_d.cpu().numpy())
                and np.array_equal(n, n_d.cpu().numpy())):
            raise AssertionError("a coalesced request differs from the "
                                 "direct call")
        if det.shape != (r.shape[0], 300, 6) or not np.isfinite(det).all():
            raise AssertionError("deployed path: bad detections")
        total += int(n.sum())
    log(f"deployed: {n_requests} requests ({stats['images']} uint8 images, "
        f"{total} detections) from {n_threads} threads equal direct "
        f"build_int_pipeline calls bit for bit")
    log(f"deployed: coalescer snapshot (smoke output of {n_requests} "
        f"closed-loop requests, not a metric) flushes={stats['flushes']} "
        f"mean_fill={stats['mean_fill']:.4f} "
        f"latency_ms p50={stats['latency_ms_p50']:.2f} "
        f"p95={stats['latency_ms_p95']:.2f} (max_batch 128, max_wait 5 ms) "
        f"on {card}")
    return stats, files


def time_pipeline(model, device, card: str, engine: str, batch: int = 128,
                  reps: int = 3):
    """Phase 7: whole pipeline (uint8 images on the card -> detections)
    at B=128, host clock around synchronized batches after a warm-up."""
    from alpha_yolo_quant_torch.engine_profile import device_ms
    import torch

    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline,
    )

    s = model.cfg.image_size
    x = torch.as_tensor(np.random.default_rng(3).integers(
        0, 256, (batch, 3, s, s)).astype(np.uint8), device=device)
    fn, _ = build_int_pipeline(model, device, engine=engine)
    fn(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        det, n = fn(x)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / reps * 1e3
    fwd = device_ms(lambda: fn(x), 1, warmup=0, spin=False)
    log(f"pipeline [{engine}] B={batch} {s}px yolov8n K=8 full-quant uint8 "
        f"in -> detections: {ms:.2f} ms/batch, {batch / ms * 1e3:.1f} img/s "
        f"(CUDA events: {fwd:.2f} ms) on {card}")
    return ms


def launch_floor_ms() -> float:
    """Device time of an empty kernel (torch.cuda._sleep(0)) back to back:
    the least time any launch takes, the floor of a kernel whose bytes and
    operations take less."""
    import torch

    from alpha_yolo_quant_torch.engine_profile import device_ms

    return device_ms(lambda: torch.cuda._sleep(0), 1000)


def artifacts_phase(model, device, card: str, golden_size: int = 64):
    """Phase 8: quantize -> export -> load back -> serve on the card. The
    directly built model's tree from export_all (golden run of one
    golden_size image), loaded back at the model's size by both loaders;
    4 uint8 images served on each engine by each loaded model, counted,
    against the direct model on that engine. Returns the phase's line."""
    import tempfile

    import torch

    from alpha_yolo_quant_torch.export.artifacts import export_all
    from alpha_yolo_quant_torch.models.params import init_params
    from alpha_yolo_quant_torch.native import fastwriter
    from alpha_yolo_quant_torch.quantize.loadq import (
        model_from_artifacts, model_from_packed_state_dict,
    )
    from alpha_yolo_quant_torch.runtime import fused_ops
    from alpha_yolo_quant_torch.runtime.golden import golden_forward
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline, slab_plan,
    )

    t_phase = time.perf_counter()
    writer = ("native (g++)" if fastwriter() is not None
              else "python (no g++: the native writer did not build)")
    x_gold = np.random.default_rng(8).uniform(
        0, 1, (1, 3, golden_size, golden_size)).astype(np.float32)
    t0 = time.perf_counter()
    env = golden_forward(model, x_gold)
    golden_s = time.perf_counter() - t0
    warnings = []
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        export_all(model, env, init_params(model.graph, seed=0), tmp,
                   warn=warnings.append)
        export_s = time.perf_counter() - t0
        files = [os.path.join(d, f) for d, _, fs in os.walk(tmp)
                 for f in fs]
        n_bytes = sum(os.path.getsize(f) for f in files)
        loaded = {"model_from_artifacts": model_from_artifacts(
                      tmp, model.cfg),
                  "model_from_packed_state_dict":
                      model_from_packed_state_dict(tmp, model.cfg)}
    s = model.cfg.image_size
    x = torch.as_tensor(np.random.default_rng(9).integers(
        0, 256, (4, 3, s, s)).astype(np.uint8), device=device)
    total = 0
    for engine in ("fused", "pallas", "packed"):
        want = build_int_pipeline(model, device, engine=engine)[0](x)
        for name, m in loaded.items():
            fn, plan = build_int_pipeline(m, device, engine=engine)
            torch.cuda.synchronize()
            fused_ops.reset_counts()
            det, n = fn(x)
            torch.cuda.synchronize()
            counts = dict(fused_ops.LAUNCHES)
            n_slab = slab_plan(m, plan).n_convs if engine == "packed" else 0
            exp = expected_launches(m, engine, n_slab)
            seen = {"conv": counts["conv1x1"] + counts["conv3x3"],
                    **{k: counts[k] for k in exp if k != "conv"}}
            if seen != exp:
                raise AssertionError(f"artifacts [{engine}] {name}: "
                                     f"launches {seen}, expected {exp}")
            if not (torch.equal(det, want[0]) and torch.equal(n, want[1])):
                raise AssertionError(f"artifacts [{engine}] {name}: the "
                                     "loaded model's detections differ "
                                     "from the built model's")
            total += int(n.sum())
        log(f"artifacts [{engine}]: both loaded models launch {exp} per "
            f"forward and serve {int(want[1].sum())} detections over 4 "
            f"uint8 {s}px images, equal to the built model bit for bit")
    return {"phase": "artifacts", "files": len(files), "bytes": n_bytes,
            "golden_px": golden_size, "golden_s": golden_s,
            "export_s": export_s, "writer": writer,
            "bit_budget_warnings": len(warnings),
            "served_px": s, "detections_compared": total,
            "seconds": time.perf_counter() - t_phase, "card": card}


def eval_phase(model, device, card: str, n_images: int = 32,
               batch: int = 12):
    """Phase 9: the eval harness on the card (see the module docstring).
    Returns the phase's line."""
    import json as _json
    import tempfile

    import torch

    from alpha_yolo_quant_torch.data import coco, prefetch
    from alpha_yolo_quant_torch.eval.harness import evaluate
    from alpha_yolo_quant_torch.eval.map_oracle import map50_95_oracle
    from alpha_yolo_quant_torch.eval.records import to_metric_arrays
    from alpha_yolo_quant_torch.runtime import fused_ops
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline, eval_nms_params,
    )

    t_phase = time.perf_counter()
    s = model.cfg.image_size
    orig_h, orig_w = 480, 640
    rng = np.random.default_rng(10)
    u8 = rng.integers(0, 256, (n_images, 3, s, s)).astype(np.uint8)
    nms = eval_nms_params(model, 0.001)
    cpu_fn = build_int_pipeline(model, "cpu", plain=True, nms_params=nms)[0]
    t0 = time.perf_counter()
    cpu = {}   # image bytes -> the CPU pipeline's (det, n) for that image
    for i in range(0, n_images, 8):
        det, n = cpu_fn(u8[i:i + 8].astype(np.float32) / 255.0)
        for j in range(det.shape[0]):
            cpu[(u8[i + j].astype(np.float32) / 255.0).tobytes()] = (
                det[j], n[j])
    cpu_s = time.perf_counter() - t0

    def cpu_step(imgs):
        rows = [cpu[np.ascontiguousarray(im).tobytes()] for im in imgs]
        return (torch.stack([d for d, _ in rows]),
                torch.stack([n for _, n in rows]))

    images, anns = [], []
    for i in range(n_images):
        det, n = cpu[(u8[i].astype(np.float32) / 255.0).tobytes()]
        det = det[: int(n)].numpy().astype(np.float64)[:24]
        keep = rng.random(len(det)) > 0.3
        wh = det[:, 2:4] - det[:, :2]
        xy1 = det[:, :2] + rng.normal(0, 0.08, (len(det), 2)) * wh
        wh = wh * np.exp(rng.normal(0, 0.15, (len(det), 2)))
        sx, sy = orig_w / s, orig_h / s
        for k in np.nonzero(keep)[0]:
            anns.append({"id": len(anns) + 1, "image_id": i,
                         "category_id": int(det[k, 5]) + 1, "iscrowd": 0,
                         "bbox": [float(xy1[k, 0] * sx),
                                  float(xy1[k, 1] * sy),
                                  float(wh[k, 0] * sx),
                                  float(wh[k, 1] * sy)]})
        images.append({"id": i, "file_name": f"{i:012d}.jpg",
                       "height": orig_h, "width": orig_w})
    with tempfile.TemporaryDirectory() as tmp:
        ann_path = os.path.join(tmp, "instances.json")
        with open(ann_path, "w") as f:
            _json.dump({"images": images, "annotations": anns,
                        "categories": [{"id": c + 1} for c in range(80)]},
                       f)
        ds = coco.CocoValDataset(os.path.join(tmp, "images"), ann_path)
    arrays = {smp.path: u8[smp.image_id].astype(np.float32) / 255.0
              for smp in ds.samples}
    card_fn = build_int_pipeline(model, device, nms_params=nms)[0]
    # the card's machine has no PIL: within this phase the dataset's image
    # decode (in data.coco and in data.prefetch's threads) is a lookup of
    # the seeded arrays; batching, staging, the step, the records and the
    # metrics are the port's own
    decode = coco.load_image_square
    coco.load_image_square = prefetch.load_image_square = \
        lambda path, size: arrays[path]
    try:
        torch.cuda.synchronize()
        fused_ops.reset_counts()
        res = evaluate(card_fn, ds, batch, s, device=device)
        torch.cuda.synchronize()
        n_conv = fused_ops.LAUNCHES["conv1x1"] + fused_ops.LAUNCHES["conv3x3"]
        # the same run with batches staged on the card from pinned memory
        res_pf = evaluate(card_fn, ds, batch, s, prefetch=True,
                          device=device)
        res_cpu = evaluate(cpu_step, ds, batch, s, device="cpu")
    finally:
        coco.load_image_square = prefetch.load_image_square = decode
    n_batches = -(-n_images // batch)
    if n_conv != len(model.graph.convs()) * n_batches:
        raise AssertionError(f"eval: {n_conv} conv launches for "
                             f"{n_batches} batches")
    oracle, _ = map50_95_oracle(*to_metric_arrays(res.ann_rows,
                                                  res.det_rows))
    if res.det_rows != res_cpu.det_rows or res.n_images != n_images:
        raise AssertionError("eval: the card's detection rows differ from "
                             "the CPU pipeline's")
    if (res_pf.det_rows, res_pf.map50_95) != (res.det_rows, res.map50_95):
        raise AssertionError("eval: prefetch=True differs from the "
                             "synchronous reader on the card")
    if not res.map50_95 == res_cpu.map50_95 == oracle:
        raise AssertionError(f"eval: mAP50-95 card {res.map50_95} CPU "
                             f"{res_cpu.map50_95} oracle {oracle}")
    if not 0.0 < res.map50_95 < 1.0:
        raise AssertionError(f"eval: mAP50-95 {res.map50_95} is not "
                             "inside (0, 1): the annotation jitter failed")
    log(f"eval: {n_images} images {s}px at batch {batch} "
        f"({n_images % batch} in a padded tail, {n_conv} conv launches), "
        f"{len(res.det_rows)} "
        f"detection rows from the card equal the CPU pipeline's (its "
        f"{n_images} images took {cpu_s:.1f} s on the host) and the "
        f"prefetch=True run's, {len(res.ann_rows)} annotations; mAP50-95 "
        f"{res.map50_95} equals the CPU run's and map50_95_oracle's")
    return {"phase": "eval", "images": n_images, "batch": batch,
            "conv_launches": n_conv,
            "det_rows": len(res.det_rows), "ann_rows": len(res.ann_rows),
            "map50_95": res.map50_95, "map50_95_oracle": oracle,
            "images_per_s": res.images_per_s,
            "images_per_s_wall": res.images_per_s_wall,
            "prefetch_images_per_s_wall": res_pf.images_per_s_wall,
            "cpu_pipeline_s": cpu_s, "seconds": time.perf_counter() - t_phase,
            "note": "rates are smoke output, not metrics", "card": card}


def sparse_phase(model, device, card: str, reqs, dense, per_engine,
                 batch: int = 128):
    """Phase 10a: phase 4's three coalesced requests through
    build_int_pipeline(sparse_select=True) on each engine, counted: the
    detections and the launches must equal phase 4's dense run's. Then
    B=128 uint8 fused dense and sparse timed in turns (dense, sparse,
    sparse, dense) with profiling.bench_fn. Returns the phase's fields."""
    import torch

    from alpha_yolo_quant_torch.runtime import fused_ops
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline,
    )
    from alpha_yolo_quant_torch.utils.profiling import bench_fn

    for engine in ("fused", "pallas", "packed"):
        torch.cuda.synchronize()
        fused_ops.reset_counts()
        fn, _ = build_int_pipeline(model, device, coalesce_requests=3,
                                   engine=engine, sparse_select=True)
        got = fn(*reqs)
        torch.cuda.synchronize()
        counts = dict(fused_ops.LAUNCHES)
        if counts != per_engine[engine]:
            raise AssertionError(f"sparse [{engine}]: launches {counts}, "
                                 f"the dense run's {per_engine[engine]}")
        for i, ((det, n), (det_d, n_d)) in enumerate(zip(got, dense)):
            if not (torch.equal(det, det_d) and torch.equal(n, n_d)):
                raise AssertionError(f"sparse [{engine}] request {i}: "
                                     "detections differ from the dense run")
        log(f"sparse [{engine}]: 3 coalesced requests equal phase 4's dense "
            f"detections bit for bit ({sum(int(n.sum()) for _, n in got)} "
            f"detections), launches {counts} as phase 4's")
    s = model.cfg.image_size
    x = torch.as_tensor(np.random.default_rng(3).integers(
        0, 256, (batch, 3, s, s)).astype(np.uint8), device=device)
    fns = {sparse: build_int_pipeline(model, device,
                                      sparse_select=sparse)[0]
           for sparse in (False, True)}
    runs = [(sparse, bench_fn(fns[sparse], x, iters=3, warmup=1,
                              device=device))
            for sparse in (False, True, True, False)]
    ms = {k: [t for sp, t in runs if sp == k] for k in (False, True)}
    log(f"sparse: B={batch} {s}px uint8 fused, CUDA events per batch in "
        f"turns dense {runs[0][1]:.2f}, sparse {runs[1][1]:.2f}, sparse "
        f"{runs[2][1]:.2f}, dense {runs[3][1]:.2f} ms on {card}")
    return {"dense_ms": ms[False], "sparse_ms": ms[True]}


BENCH_RUNS = [   # bench.main arguments timed in phase 10b
    dict(engine="fused"), dict(engine="fused", input_dtype="u8"),
    dict(engine="pallas", input_dtype="u8"),
    dict(engine="packed", input_dtype="u8"),
    dict(engine="fused", coalesce=2, batch=64)]


def bench_phase(device) -> list:
    """Phase 10b: the port's bench on the card for each of BENCH_RUNS,
    counted: each run must launch its engine's kernels. Returns the JSON
    lines (printed by bench.main as it runs)."""
    import torch

    from alpha_yolo_quant_torch import bench
    from alpha_yolo_quant_torch.runtime import fused_ops

    lines = []
    for kw in BENCH_RUNS:
        torch.cuda.synchronize()
        fused_ops.reset_counts()
        err = io.StringIO()
        with contextlib.redirect_stderr(err):   # bench's card/ms line
            line = bench.main(device=str(device), **kw)
        torch.cuda.synchronize()
        log(err.getvalue().strip())
        counts = dict(fused_ops.LAUNCHES)
        if min(counts[k] for k in ENGINE_KERNELS[kw["engine"]]) < 1:
            raise AssertionError(f"bench {line['metric']} [{kw['engine']}]:"
                                 f" its kernels did not launch: {counts}")
        if not line["value"] > 0 or line["device"] != \
                torch.cuda.get_device_name(device):
            raise AssertionError(f"bench: bad line {line}")
        log(f"bench {line['metric']} [{kw['engine']}]: launches {counts}")
        lines.append(dict(line, engine=kw["engine"]))
    return lines


def profiling_phase(model, device, batch: int = 8) -> dict:
    """Phase 10c: one B=8 fused batch inside profiling.device_trace; its
    chrome trace must hold device kernel events of the conv kernels."""
    import tempfile

    import torch

    from alpha_yolo_quant_torch.engine_profile import PORT_KERNELS
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline,
    )
    from alpha_yolo_quant_torch.utils.profiling import device_trace

    s = model.cfg.image_size
    x = torch.as_tensor(np.random.default_rng(11).integers(
        0, 256, (batch, 3, s, s)).astype(np.uint8), device=device)
    fn, _ = build_int_pipeline(model, device)
    fn(x)
    torch.cuda.synchronize()
    conv_symbol = next(k for k, v in PORT_KERNELS.items()
                       if v == "conv1x1/conv3x3")
    with tempfile.TemporaryDirectory() as tmp:
        with device_trace(tmp) as path:
            fn(x)
            torch.cuda.synchronize()
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    convs = [e for e in kernels if conv_symbol in e.get("name", "")]
    n_conv = len(model.graph.convs())
    if len(convs) < n_conv:
        raise AssertionError(f"profiling: the trace holds {len(convs)} "
                             f"{conv_symbol} kernel events of {len(kernels)}"
                             f" device kernels, expected {n_conv}")
    log(f"profiling: device_trace of one B={batch} fused batch holds "
        f"{len(kernels)} device kernel events, {len(convs)} of them "
        f"{conv_symbol} ({sum(e.get('dur', 0) for e in convs) / 1e3:.3f} "
        f"ms)")
    return {"kernel_events": len(kernels), "conv_events": len(convs)}


def hwsim_phase() -> dict:
    """Phase 10d: the CLI's info, memsim and memsim --min-buffer at 640 on
    the card's host (no PIL, no matplotlib there): the yolov8n plan's peak
    must be the reference buffer, 2,867,200 cells, and final_memory.txt
    written."""
    import tempfile

    from alpha_yolo_quant_torch import cli

    def run(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if cli.main(argv) not in (0, None):
                raise AssertionError(f"cli {argv[0]} failed")
        return buf.getvalue()

    info = run(["info"]).splitlines()
    with tempfile.TemporaryDirectory() as tmp:
        memsim = run(["memsim", "--out", tmp]).strip()
        final = os.path.join(tmp, "results", "final_memory.txt")
        if not os.path.isfile(final) or os.path.getsize(final) == 0:
            raise AssertionError("memsim wrote no final_memory.txt")
    min_buf = run(["memsim", "--min-buffer"]).strip()
    want = "peak occupancy: 2867200 cells"
    if not memsim.startswith(want) or "min buffer: 2867200 cells" not in \
            min_buf or not info[-1].startswith("SRAM plan: peak 2867200"):
        raise AssertionError(f"hwsim: {memsim!r} {min_buf!r} {info[-1]!r}")
    for line in (info[0], info[-1], memsim, min_buf):
        log(f"hwsim: {line}")
    return {"peak_cells": 2867200, "info_lines": len(info)}


def _host(tree):
    """Numpy copies of every tensor of a tree (dicts, lists, tuples)."""
    import torch

    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_host(v) for v in tree)
    return tree.cpu().numpy() if isinstance(tree, torch.Tensor) else tree


def _conv_launches() -> int:
    from alpha_yolo_quant_torch.runtime import fused_ops

    return fused_ops.LAUNCHES["conv1x1"] + fused_ops.LAUNCHES["conv3x3"]


def _nccl_rank(rank, model, params, reqs, tap_images):
    """Phase 11a on one NCCL rank per card: phase 4's requests through
    data_parallel_step, with every rank's conv kernel launches counted,
    and the calibration taps of sharded_forward_fn."""
    import torch
    import torch.distributed as dist

    from alpha_yolo_quant_torch.models.params import params_to_torch
    from alpha_yolo_quant_torch.parallel.mesh import (
        data_parallel_step, gather_batch, make_mesh, sharded_forward_fn,
    )
    from alpha_yolo_quant_torch.runtime import fused_ops
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline,
    )

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh()
    step = data_parallel_step(build_int_pipeline(model, dev)[0], mesh)
    torch.cuda.synchronize(dev)
    fused_ops.reset_counts()
    served = [gather_batch(mesh, step(r)) for r in reqs]
    torch.cuda.synchronize(dev)
    launches = [None] * dist.get_world_size()
    dist.all_gather_object(launches, _conv_launches())
    taps = sharded_forward_fn(model.graph, mesh, collect_taps=True)(
        params_to_torch(params, dev), tap_images)["taps"]
    return _host({"served": served, "taps": taps, "launches": launches})


def _gloo_card_rank(rank, model, params, x, x_tp):
    """Phase 11b on four gloo ranks sharing cuda:0: dp=2, pp S=2 and S=4
    (one image per microbatch), sp=2, sp=4, dp x sp 2x2 and tp=2, each
    with its seconds on rank 0 and, but for tp's float convs, every rank's
    conv kernel launches in that run."""
    import torch
    import torch.distributed as dist

    from alpha_yolo_quant_torch.models.params import params_to_torch
    from alpha_yolo_quant_torch.parallel.mesh import (
        data_parallel_step, dp_sp_parallel_fn, gather_batch, in_mesh,
        make_mesh, make_mesh_2d, shard_params_tp, spatial_parallel_fn,
        tensor_parallel_fn,
    )
    from alpha_yolo_quant_torch.parallel.pipeline import (
        build_pipeline_spec, pipeline_forward,
    )
    from alpha_yolo_quant_torch.runtime import fused_ops
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline, device_plan,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    meshes = {"dp2": make_mesh(2), "pp2": make_mesh(2, axis="pp"),
              "pp4": make_mesh(4, axis="pp"), "sp2": make_mesh(2, axis="sp"),
              "sp4": make_mesh(4, axis="sp"),
              "dp2xsp2": make_mesh_2d(2, 2, axes=("dp", "sp")),
              "tp2": make_mesh(2, axis="tp")}
    plan = device_plan(model, dev)
    res, secs, counts = {}, {}, {}

    def run(name, build, drive):
        mesh = meshes[name]
        if in_mesh(mesh):
            f = build(mesh)
            torch.cuda.synchronize(dev)
            fused_ops.reset_counts()
            t0 = time.perf_counter()
            res[name] = drive(mesh, f)
            torch.cuda.synchronize(dev)
            secs[name] = time.perf_counter() - t0
            counts[name] = _conv_launches()

    run("dp2", lambda m: data_parallel_step(build_int_pipeline(model, dev)[0],
                                            m),
        lambda m, f: gather_batch(m, f(x)))
    for s in (2, 4):
        run(f"pp{s}", lambda m, s=s: pipeline_forward(
            model, plan, build_pipeline_spec(model, s, 1, x.shape[0]), m),
            lambda m, f: f(x))
    for s in (2, 4):
        run(f"sp{s}", lambda m: spatial_parallel_fn(model, m, device=dev),
            lambda m, f: f(x))
    run("dp2xsp2", lambda m: dp_sp_parallel_fn(model, m, device=dev),
        lambda m, f: gather_batch(m, f(x)))
    run("tp2", lambda m: tensor_parallel_fn(model.graph, m),
        lambda m, f: f(shard_params_tp(m, params_to_torch(params, dev)),
                       x_tp))
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, counts)
    launches = {k: [c[k] for c in per_rank if k in c]
                for k in meshes if k != "tp2"}
    return _host({"res": res, "seconds": secs, "launches": launches})


def parallel_phase(model, device, card: str, reqs, dense, calib_files):
    """Phase 11: parallel/{mesh, pipeline} on the card, from the parent's
    built kernels and the phase-2 model passed to every rank.

    (a) NCCL, one rank per visible card (at most 4, a power of two):
    data_parallel_step serves phase 4's three requests equal to phase 4's
    detections, each rank launching its conv kernels 63 times per request;
    sharded_forward_fn's MAX all-reduced taps of phase 4's 8 f32 images
    equal a single-rank forward within rtol 1e-6 (JAX's tolerance; the
    error is printed); the CLI's calibrate --dp <world> on phase 6's
    weights writes phase 6's max_a.txt: byte for byte at world size 1, and
    every tap within rtol 1e-6 at a larger world.
    (b) four gloo ranks sharing cuda:0 (NCCL refuses two ranks on one
    card), phase 4's four uint8 images: dp=2 detections, pp S=2 and S=4
    head edges (microbatch 1) and sp=2, sp=4 and dp x sp 2x2 preds equal
    the unsharded fused run bit for bit; every dp, sp and dp x sp rank
    launches its conv kernels 63 times (one forward), the pp ranks' sum to
    63 per microbatch; tp=2 float preds of two f32 images within rtol 1e-4
    of the unsharded float forward. Returns the phase's line."""
    import tempfile

    import torch

    from alpha_yolo_quant_torch import cli
    from alpha_yolo_quant_torch.models.forward import forward_float
    from alpha_yolo_quant_torch.models.head import decode_float
    from alpha_yolo_quant_torch.models.params import (
        init_params, params_to_torch,
    )
    from alpha_yolo_quant_torch.parallel.mesh import run_ranks
    from alpha_yolo_quant_torch.runtime.interpreter import (
        build_int_pipeline, device_plan, int_forward, quantize_input,
    )
    from alpha_yolo_quant_torch.utils.io import read_max_a

    t_phase = time.perf_counter()
    graph = model.graph
    s = model.cfg.image_size
    n_cards = torch.cuda.device_count()
    world = 4 if n_cards >= 4 else 2 if n_cards >= 2 else 1
    n_conv = len(graph.convs())
    params = init_params(graph, seed=0)
    tparams = params_to_torch(params, device)
    reqs_np = [r.cpu().numpy() for r in reqs]

    t0 = time.perf_counter()
    got = run_ranks(_nccl_rank, (model, params, reqs_np, reqs_np[1]), world,
                    "nccl", deadline_s=600)
    a_ranks_s = time.perf_counter() - t0
    for i, ((det, n), (det_w, n_w)) in enumerate(zip(got["served"], dense)):
        if not (np.array_equal(det, det_w.cpu().numpy())
                and np.array_equal(n, n_w.cpu().numpy())):
            raise AssertionError(f"parallel (a): dp request {i} differs "
                                 "from phase 4")
    a_launches = got["launches"]
    if a_launches != [n_conv * len(reqs_np)] * world:
        raise AssertionError(f"parallel (a): dp launches {a_launches}, "
                             f"expected {n_conv} per request on each rank")
    with torch.no_grad():
        _, taps = forward_float(graph, tparams, torch.as_tensor(
            reqs_np[1], device=device), collect_taps=True)
    taps_err = max(abs(float(got["taps"][k]) - float(torch.amax(v)))
                   / max(abs(float(torch.amax(v))), 1e-30)
                   for k, v in taps.items())
    if sorted(got["taps"]) != sorted(taps) or taps_err > 1e-6:
        raise AssertionError(f"parallel (a): taps differ by {taps_err} "
                             "relative")
    log(f"parallel (a) backend nccl, world {world}: data_parallel_step "
        f"serves phase 4's 3 requests equal to phase 4 (conv launches per "
        f"rank {a_launches}); "
        f"{len(taps)} all-reduced taps of 8 images, max relative error "
        f"{taps_err:.3g} against one rank")
    with tempfile.TemporaryDirectory() as tmp:
        npz = os.path.join(tmp, "weights_batchnf.npz")
        with open(npz, "wb") as f:
            f.write(calib_files["npz"])
        out = os.path.join(tmp, "8_nano")
        t0 = time.perf_counter()
        if cli.main(["calibrate", "--weights", npz, "--out", out,
                     "--device", "cuda", "--dp", str(world),
                     "--image-size", str(s)]) != 0:
            raise AssertionError("calibrate --dp failed")
        cal_s = time.perf_counter() - t0
        path = os.path.join(out, "results", "max_a.txt")
        with open(path, "rb") as f:
            max_a = f.read()
        taps_got = read_max_a(path)
        ref_path = os.path.join(tmp, "max_a_phase6.txt")
        with open(ref_path, "wb") as f:
            f.write(calib_files["max_a"])
        taps_want = read_max_a(ref_path)
    if world == 1 and max_a != calib_files["max_a"]:
        raise AssertionError("parallel (a): calibrate --dp 1 wrote another "
                             "max_a.txt than phase 6")
    if list(taps_got) != list(taps_want):
        raise AssertionError("parallel (a): calibrate --dp wrote other taps "
                             "than phase 6")
    for tap, v in taps_got.items():
        np.testing.assert_allclose(v, taps_want[tap], rtol=1e-6,
                                   err_msg=f"parallel (a): calibrate --dp "
                                           f"{world} tap {tap}")
    log(f"parallel (a) backend nccl: cli calibrate --dp {world} "
        f"({cal_s:.1f} s) wrote phase 6's max_a.txt, "
        + ("byte for byte" if world == 1 else
           f"all {len(taps_got)} taps within rtol 1e-6"))

    x, x_tp = reqs_np[0], reqs_np[1][:2]
    t0 = time.perf_counter()
    got = run_ranks(_gloo_card_rank, (model, params, x, x_tp), 4, "gloo",
                    deadline_s=600)
    b_ranks_s = time.perf_counter() - t0
    res, secs, b_launches = got["res"], got["seconds"], got["launches"]
    xd = torch.as_tensor(x, device=device)
    plan = device_plan(model, device)
    heads = {r: t.cpu().numpy() for r, t in int_forward(
        model, plan, quantize_input(xd, model.cfg.k)).items()}
    det, n = build_int_pipeline(model, device)[0](xd)
    preds = build_int_pipeline(model, device, with_nms=False)[0](xd)
    preds = preds.cpu().numpy()
    if not (np.array_equal(res["dp2"][0], det.cpu().numpy())
            and np.array_equal(res["dp2"][1], n.cpu().numpy())):
        raise AssertionError("parallel (b): dp=2 detections differ")
    for k in ("pp2", "pp4"):
        for role, want in res[k].items():
            if not np.array_equal(want, heads[role]):
                raise AssertionError(f"parallel (b): {k} {role} differs")
        if sum(b_launches[k]) != n_conv * x.shape[0] or min(
                b_launches[k]) < 1:
            raise AssertionError(f"parallel (b): {k} launches "
                                 f"{b_launches[k]}, expected "
                                 f"{n_conv} per microbatch")
    for k in ("sp2", "sp4", "dp2xsp2"):
        if not np.array_equal(res[k], preds):
            raise AssertionError(f"parallel (b): {k} preds differ")
    for k, n_ranks in (("dp2", 2), ("sp2", 2), ("sp4", 4), ("dp2xsp2", 4)):
        if b_launches[k] != [n_conv] * n_ranks:
            raise AssertionError(f"parallel (b): {k} launches "
                                 f"{b_launches[k]}, expected {n_conv} on "
                                 "each rank")
    with torch.no_grad():
        outs, _ = forward_float(graph, tparams, torch.as_tensor(
            x_tp, device=device))
        fp = decode_float(outs, tparams["dfl"]["w"]).cpu().numpy()
    tp_err = float(np.max(np.abs(res["tp2"] - fp)
                          / np.maximum(np.abs(fp), 1e-6)))
    np.testing.assert_allclose(res["tp2"], fp, rtol=1e-4, atol=1e-6)
    log(f"parallel (b) backend gloo, 4 ranks sharing cuda:0: dp=2, pp "
        f"S=2/S=4, sp=2, sp=4 and dp x sp 2x2 equal the unsharded fused run "
        f"bit for bit (conv launches per rank {b_launches}); tp=2 float "
        f"preds max relative error {tp_err:.3g}")
    return {"phase": "parallel", "backends": {"a": "nccl", "b": "gloo"},
            "world_sizes": {"a": world, "b": 4},
            "launches": dict(b_launches, a_dp=a_launches),
            "taps_max_rel_err": taps_err, "tp_max_rel_err": tp_err,
            "rank_seconds": {k: round(v, 4) for k, v in secs.items()},
            "a_seconds": a_ranks_s, "a_calibrate_seconds": cal_s,
            "b_seconds": b_ranks_s,
            "seconds": time.perf_counter() - t_phase, "card": card}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the card and has no CPU path")
    from alpha_yolo_quant_torch.engine_profile import build_model
    from alpha_yolo_quant_torch.runtime import _build
    from alpha_yolo_quant_torch.runtime.interpreter import device_plan

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    log(card)
    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for "
        f"{len(_build.SOURCES)} sources (sm_90a)")
    for name, so in _build.targets().items():
        log_file = so.with_suffix(".log")
        rep = log_file.read_text() if log_file.exists() else ""
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", rep)]
        spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                               rep))
        log(f"ptxas {name}: {len(regs)} kernels, {min(regs, default=0)}-"
            f"{max(regs, default=0)} registers, {spill} bytes spill stores")
    check_tensor_cores()

    t0 = time.perf_counter()
    model = build_model(640, dev)   # the model engine_profile measures
    log(f"model: yolov8n K=8 full-quant 640, random weights seed 0, "
        f"port calibration ({time.perf_counter() - t0:.1f} s)")
    kres = check_kernels(model, device_plan(model, dev), batch=8)
    launches, plans, reqs, dense, per_engine = serve(model, dev)
    golden_heads(model, plans["fused"], reqs[0][:1])
    check_against_cpu(model, dev)
    check_partial_quant(dev)
    _, calib_files = deployed_path(dev, card)
    for engine in ("fused", "pallas", "packed"):
        time_pipeline(model, dev, card, engine)
    log(json.dumps(artifacts_phase(model, dev, card)))
    log(json.dumps(eval_phase(model, dev, card)))
    t0 = time.perf_counter()
    sparse = sparse_phase(model, dev, card, reqs, dense, per_engine)
    bench_lines = bench_phase(dev)
    prof = profiling_phase(model, dev)
    hw = hwsim_phase()
    log(json.dumps({"phase": "sparse_bench_profiling_hwsim", **sparse,
                    "bench": bench_lines, **prof, **hw,
                    "seconds": time.perf_counter() - t0, "card": card}))
    log(json.dumps(parallel_phase(model, dev, card, reqs, dense,
                                  calib_files)))
    kres["sigma_probe"]["launch_floor_ms"] = launch_floor_ms()
    log(f"chip_smoke: all phases passed in "
        f"{time.perf_counter() - t_start:.1f} s on {card}")
    log(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=KERNELS[k][0],
             replaces=KERNELS[k][1], launches=launches[k],
             max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=r["library_ms"],
             shape=r["shape"],
             **({"launch_floor_ms": r["launch_floor_ms"]}
                if "launch_floor_ms" in r else {}))
        for k, r in kres.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
