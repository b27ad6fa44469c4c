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
then print the kernels line (every kernel with its launches on its path,
error, times and bound) and, last, the device line.
"""

from __future__ import annotations

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
        sass = subprocess.run([tool, "-sass", _build.BUILD_INFO[f"lib_{name}"]],
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
    launches, plans = {}, {}
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
    return launches, plans, reqs


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
    coalescer's snapshot."""
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
    return stats


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the card and has no CPU path")
    from alpha_yolo_quant_torch.engine_profile import build_model
    from alpha_yolo_quant_torch.runtime import _build
    from alpha_yolo_quant_torch.runtime.interpreter import device_plan

    dev = torch.device("cuda")
    card = card_line()
    log(card)
    _build.build()
    log(f"build: {_build.BUILD_INFO['seconds']:.1f} s for "
        f"{len(_build.SOURCES)} sources (sm_90a)")
    for name in _build.SOURCES:
        rep = _build.BUILD_INFO.get(f"ptxas_{name}", "")
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
    launches, plans, reqs = serve(model, dev)
    golden_heads(model, plans["fused"], reqs[0][:1])
    check_against_cpu(model, dev)
    check_partial_quant(dev)
    deployed_path(dev, card)
    for engine in ("fused", "pallas", "packed"):
        time_pipeline(model, dev, card, engine)
    log(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=KERNELS[k][0],
             replaces=KERNELS[k][1], launches=launches[k],
             max_abs_err=r["max_abs_err"], ms=r["ms"],
             plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
             bound_by=r["bound_by"], library_ms=r["library_ms"],
             shape=r["shape"])
        for k, r in kres.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
