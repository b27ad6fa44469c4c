"""Wrappers of the Hopper kernels (counterpart of
alpha_yolo_quant_tpu/runtime/pallas_ops.py). The banded slab conv's
wrapper lives beside its layout code in runtime/packed_conv.py and counts
its launches here too.

Each kernel has its plain PyTorch version in this module and a launch
count in ``LAUNCHES``. A wrapper given a CPU tensor runs the plain
version; given a CUDA tensor it launches the kernel (runtime/csrc, built
on first use by runtime/_build.py) or raises. There is no fallback from a
failed launch.

Activations are NHWC. A conv's plan entry (interpreter.device_plan) holds
its weights twice: OIHW float64 for the plain version and the tensor-core
kernels' B operand, (Cout, Kp) int8 with the depth tap-major and
contiguous per output channel (pack_weights). On a CUDA device the entry
also holds the B operand's TMA descriptor for its column tiles (tile_n),
encoded once when the entry is made. A depthwise conv's entry
(dwconv_entry) holds its weights as (9, C) int8 for dwconv3x3 instead.

A plain conv inside the network (YOLO11's qkv, pe, proj and FFN convs:
ConvNode.requant_out) runs the SiLU epilogue with r1 = 0, s1 = 1 and the
table of ones (quantize/luts.unit_lut): its output is then the plain
requant clip(rhu((r2 * acc) >> (s2 - 1))), int8.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from alpha_yolo_quant_torch.ops.intmath import requantize, requantize_small
from alpha_yolo_quant_torch.ops.lut import DeviceLut
from alpha_yolo_quant_torch.ops.nn import conv2d_int_exact

# kernel launches since the last reset_counts(); only a launch of the
# kernel itself counts, never a plain-version call. A conv launch counts
# under its wrapper (conv1x1, conv3x3) and under the loader that fed its
# input rows (conv_loader): conv_vector, conv_wide or conv_gather
LAUNCHES: Dict[str, int] = {"conv1x1": 0, "conv3x3": 0, "conv_vector": 0,
                            "conv_wide": 0, "conv_gather": 0,
                            "sigma_probe": 0, "postconv_silu": 0,
                            "postconv_plain": 0, "packed_conv": 0,
                            "glue_add": 0, "glue_concat": 0, "dwconv": 0,
                            "attn": 0}

K_TILE = 64        # packed weight depth is zero-padded to a multiple of it
#                    (the conv kernels' stages hold 128 bytes of depth and
#                    read past Kp as zeros)
MAX_TILE_N = 256   # widest column tile: wgmma's largest N
MAX_COUT = 1024    # conv_igemm.cuh MAX_NP: the constants a block holds
MAX_LUT = 256      # epilogue.cuh kMaxLut: the longest sigmoid table
CHUNK = 16         # channels per cp.async copy (conv_igemm.cuh): inputs
#                    with Cin % CHUNK == 0 are read 16 bytes at a time
MAX_SOURCES = 8    # glue.cu kGlueParts: the most sources of one concat
ATTN_DIMS = (32, 64)   # attn.cu kAttnKd, kAttnHd: key_dim and head_dim
MAX_ATTN_N = 1792      # attn.cu: the most pixels whose q, k and v (128
#                        bytes each) and exponent table fit 227 KB of
#                        shared memory
_ACT_TYPES = (torch.int8, torch.int16)


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def packed_depth(depth: int) -> int:
    """Kp: a conv's depth k*k*Cin rounded up to K_TILE."""
    return -(-depth // K_TILE) * K_TILE


def pack_weights(w_q: np.ndarray) -> np.ndarray:
    """OIHW integer weights -> the kernels' B operand, int8 (O, Kp): row n
    holds output channel n at depth k = (dy*kw + dx)*Cin + c, zero-padded
    to Kp, a multiple of K_TILE (K-major, the layout wgmma reads)."""
    o = w_q.shape[0]
    wk = np.ascontiguousarray(w_q.transpose(0, 2, 3, 1)).reshape(o, -1)
    kp = packed_depth(wk.shape[1])
    return np.ascontiguousarray(
        np.pad(wk, ((0, 0), (0, kp - wk.shape[1]))).astype(np.int8))


def tile_n(cout: int) -> int:
    """Columns of the conv kernels' output tile for Cout channels: Cout
    spread evenly over ceil(Cout / MAX_TILE_N) column tiles, the share
    rounded up to a multiple of 16 (a legal wgmma.m64nNk32 width), so a
    tile is at most 15 columns wider than an even share of Cout."""
    n_tiles = -(-cout // MAX_TILE_N)
    return 16 * -(-cout // (16 * n_tiles))


def conv_loader(x: torch.Tensor, cin: int) -> str:
    """The LAUNCHES key of the loader that feeds a conv's input rows:
    conv_gather where Cin % CHUNK != 0 (element by element), else
    conv_wide for int16 input (two byte passes), else conv_vector."""
    if cin % CHUNK:
        return "conv_gather"
    return "conv_wide" if x.dtype == torch.int16 else "conv_vector"


def _weight_map(c: Dict) -> ctypes.Array:
    """The B operand's TMA descriptor for tiles of tile_n(cout) columns,
    kept in the entry with the address it was encoded for."""
    from alpha_yolo_quant_torch.runtime._build import kernel

    w = c["w_packed"]
    bn = tile_n(c["cout"])
    key = (w.data_ptr(), tuple(w.shape), bn)
    if c.get("w_map") is not None and c["w_map"][0] == key:
        return c["w_map"][1]
    buf = ctypes.create_string_buffer(128)
    lib = "conv1x1" if c["kernel"] == 1 else "conv3x3"
    rc = kernel(lib, "ayq_conv_weight_map")(w.data_ptr(), w.shape[0],
                                            w.shape[1], bn,
                                            ctypes.addressof(buf))
    if rc != 0:
        raise RuntimeError(f"{lib}: weight tensor map not encoded "
                           f"(rc {rc})")
    c["w_map"] = (key, buf)
    return buf


def conv_entry(w_q, b_q, stride: int, padding: int, silu: bool, device,
               r1=None, s1=None, r2=None, s2=None) -> Dict:
    """One conv's tensors in the form every wrapper here takes: weights
    for both versions, per-output-channel int32 constants, geometry, and
    on a CUDA device the weights' TMA descriptor."""
    w_q = np.asarray(w_q)
    c = {"w_f64": torch.as_tensor(w_q, dtype=torch.float64, device=device),
         "w_packed": torch.as_tensor(pack_weights(w_q), device=device),
         "b": torch.as_tensor(np.asarray(b_q).reshape(-1), dtype=torch.int32,
                              device=device),
         "kernel": int(w_q.shape[2]), "stride": int(stride),
         "padding": int(padding), "silu": bool(silu),
         "cin": int(w_q.shape[1]), "cout": int(w_q.shape[0]), "groups": 1,
         "w_map": None}
    if silu:
        for f, v in (("r1", r1), ("s1", s1), ("r2", r2), ("s2", s2)):
            c[f] = torch.as_tensor(np.asarray(v).reshape(-1),
                                   dtype=torch.int32, device=device)
    if c["w_packed"].is_cuda and c["kernel"] in (1, 3) \
            and c["cout"] <= MAX_COUT:
        _weight_map(c)
    return c


def requant_consts(r2, s2):
    """(r1, s1, r2, s2) of a plain conv inside the network: the SiLU
    epilogue's first requant reads 0, its table the ones of unit_lut."""
    r2 = np.asarray(r2).reshape(-1)
    return np.zeros_like(r2), np.ones_like(r2), r2, np.asarray(s2)


def dwconv_entry(w_q, b_q, device, r1, s1, r2, s2) -> Dict:
    """A depthwise 3x3 conv's tensors: the OIHW float64 weights (C, 1, 3,
    3) of the plain version, the kernel's (9, C) int8 taps, the
    per-channel int32 bias and requant constants (a plain conv's from
    requant_consts, read with unit_lut)."""
    w_q = np.asarray(w_q)
    cout = int(w_q.shape[0])
    c = {"w_f64": torch.as_tensor(w_q, dtype=torch.float64, device=device),
         "w_taps": torch.as_tensor(np.ascontiguousarray(
             w_q.reshape(cout, 9).T).astype(np.int8), device=device),
         "b": torch.as_tensor(np.asarray(b_q).reshape(-1), dtype=torch.int32,
                              device=device),
         "kernel": 3, "stride": 1, "padding": 1, "cin": 1, "cout": cout,
         "groups": cout}
    for f, v in (("r1", r1), ("s1", s1), ("r2", r2), ("s2", s2)):
        c[f] = torch.as_tensor(np.asarray(v).reshape(-1), dtype=torch.int32,
                               device=device)
    return c


def attn_entry(a, device) -> Dict:
    """An attention node's constants (quantize/transform.AttnPlan): its
    shape, the scalar logit and output requants and the exponent table."""
    n = a.node
    return {"heads": n.heads, "key_dim": n.key_dim, "head_dim": n.head_dim,
            "logit": (a.logit_r, a.logit_s), "out": (a.out_r, a.out_s),
            "exp": DeviceLut(a.exp_lut, device)}


# ---------------------------------------------------------------- plain

def conv_acc_plain(x: torch.Tensor, c: Dict) -> torch.Tensor:
    """Exact accumulator + bias, NHWC int64 (the plain conv)."""
    acc = conv2d_int_exact(x.permute(0, 3, 1, 2), c["w_f64"], c["stride"],
                           c["padding"], c["groups"])
    return acc.permute(0, 2, 3, 1) + c["b"]


def silu_epilogue_plain(acc: torch.Tensor, c: Dict, sig: DeviceLut,
                        qmax: int) -> torch.Tensor:
    dom = requantize(acc, c["r1"], c["s1"], qmax)
    sigma = sig.apply_clipped(dom).to(torch.int64)
    return requantize(acc, sigma * c["r2"], c["s2"], qmax).to(torch.int8)


def conv_plain(x: torch.Tensor, c: Dict, sig: DeviceLut,
               qmax: int) -> torch.Tensor:
    """The plain version of conv1x1 and conv3x3: int8 NHWC (SiLU) or the
    raw int32 accumulators (plain head convs)."""
    acc = conv_acc_plain(x, c)
    if not c["silu"]:
        return acc.to(torch.int32).contiguous()
    return silu_epilogue_plain(acc, c, sig, qmax).contiguous()


def dwconv3x3_plain(x: torch.Tensor, c: Dict, sig: DeviceLut,
                    qmax: int) -> torch.Tensor:
    """The plain version of dwconv3x3: int8 NHWC."""
    return silu_epilogue_plain(conv_acc_plain(x, c), c, sig,
                               qmax).contiguous()


def attention_plain(qkv: torch.Tensor, a: Dict, qmax: int):
    """The plain version of attention, on any device: the products in
    float64, where every value is an integer below 2^53, so they are
    exact; every other step in int64 (runtime/golden.attention_np is the
    contract). Returns (out, v), int8 NHWC, channel h * head_dim + d."""
    b, hh, ww, _ = qkv.shape
    heads, kd, hd = a["heads"], a["key_dim"], a["head_dim"]
    t = qkv.reshape(b, hh * ww, heads, 2 * kd + hd).permute(0, 2, 1, 3)
    t = t.to(torch.float64)                               # (b, heads, N, .)
    q, k, v = t[..., :kd], t[..., kd:2 * kd], t[..., 2 * kd:]
    logits = (q @ k.transpose(2, 3)).to(torch.int64)
    lq = requantize(logits, a["logit"][0], a["logit"][1], 127)
    e = a["exp"].apply(lq - torch.amax(lq, dim=3, keepdim=True))
    acc = (e.to(torch.float64) @ v).to(torch.int64)       # (b, heads, N, hd)
    o = torch.div(acc, e.to(torch.int64).sum(dim=3, keepdim=True),
                  rounding_mode="floor")
    out = requantize(o, a["out"][0], a["out"][1], qmax).to(torch.int8)

    def nhwc(u):
        return u.permute(0, 2, 1, 3).reshape(b, hh, ww, heads * hd) \
            .contiguous()
    return nhwc(out), nhwc(v.to(torch.int8))


def sigma_probe_plain(sig: DeviceLut) -> torch.Tensor:
    dom = torch.arange(sig.lo, sig.hi + 1, device=sig.values.device)
    return sig.apply_clipped(dom)


def _channel_shape(t: torch.Tensor, axis: int):
    shape = [1] * t.dim()
    shape[axis] = -1
    return shape


def _postconv_acc_plain(hi, lo, bias, axis: int) -> torch.Tensor:
    """16*hi + lo + bias in int64 (hi, lo: float32 holding integers)."""
    return (hi.to(torch.int64) * 16 + lo.to(torch.int64)
            + bias.to(torch.int64).reshape(_channel_shape(hi, axis)))


def postconv_silu_plain(hi, lo, bias, r1, s1, r2, s2, sig: DeviceLut,
                        qmax: int = 127, axis: int = 1) -> torch.Tensor:
    acc = _postconv_acc_plain(hi, lo, bias, axis)
    shape = _channel_shape(hi, axis)
    c = {f: v.reshape(shape) for f, v in
         (("r1", r1), ("s1", s1), ("r2", r2), ("s2", s2))}
    return silu_epilogue_plain(acc, c, sig, qmax)


def postconv_plain_plain(hi, lo, bias, axis: int = 1) -> torch.Tensor:
    return _postconv_acc_plain(hi, lo, bias, axis).to(torch.int32)


def residual_add_plain(src: torch.Tensor, base: torch.Tensor, r: int, s: int,
                       qmax: int, bound: Optional[int],
                       dtype: torch.dtype) -> torch.Tensor:
    """requant(src) + base, clipped to +-bound if a bound is given, then
    cast (two's-complement truncation) to dtype."""
    out = requantize_small(src, r, s, qmax) + base.to(torch.int32)
    if bound is not None:
        out = torch.clamp(out, -bound, bound)
    return out.to(dtype)


def concat_plain(srcs: Sequence[torch.Tensor],
                 requants: Sequence[Optional[Tuple[int, int]]], qmax: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """Each source requantized where it has an (r, s), cast to dtype, then
    concatenated along the channels (NHWC)."""
    parts = []
    for t, rq in zip(srcs, requants):
        if rq is not None:
            t = requantize_small(t, rq[0], rq[1], qmax)
        parts.append(t.to(dtype))
    return torch.cat(parts, dim=3)


# --------------------------------------------------------------- kernels

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _check_table(name: str, sig: DeviceLut, qmax: int) -> None:
    n = sig.values.numel()
    if n > MAX_LUT or sig.lo > -qmax or sig.hi < qmax:
        raise ValueError(f"{name}: sigmoid table [{sig.lo}, {sig.hi}] "
                         f"must cover +-{qmax} in <= {MAX_LUT} entries")


def _check_conv(name: str, x: torch.Tensor, c: Dict, sig, qmax: int):
    if x.dtype not in _ACT_TYPES:
        raise TypeError(f"{name}: activations must be int8 or int16, "
                        f"got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous NHWC tensor")
    if x.shape[3] != c["cin"]:
        raise ValueError(f"{name}: {x.shape[3]} input channels, weights "
                         f"take {c['cin']}")
    if c["cin"] % CHUNK == 0 and x.data_ptr() % 16:
        # the vector path copies 16 channels at a time, 16-byte aligned
        raise ValueError(f"{name}: input not 16-byte aligned")
    w = c["w_packed"]
    shape = (c["cout"], packed_depth(c["kernel"] ** 2 * c["cin"]))
    if w.dtype != torch.int8 or tuple(w.shape) != shape \
            or not w.is_contiguous():
        raise ValueError(f"{name}: packed weights must be contiguous int8 "
                         f"{shape} (pack_weights), got {w.dtype} "
                         f"{tuple(w.shape)}")
    if w.data_ptr() % 16:
        raise ValueError(f"{name}: packed weights not 16-byte aligned")
    if w.device != x.device:
        raise ValueError(f"{name}: weights on {w.device}, "
                         f"input on {x.device}")
    if c["cout"] > MAX_COUT:
        raise ValueError(f"{name}: {c['cout']} output channels, the kernel "
                         f"takes at most {MAX_COUT}")
    if c["silu"]:
        _check_table(name, sig, qmax)


def _launch_conv(name: str, x: torch.Tensor, c: Dict, sig, qmax: int):
    from alpha_yolo_quant_torch.runtime._build import kernel

    _check_conv(name, x, c, sig, qmax)
    b, h, w, cin = x.shape
    stride = c["stride"]
    ho, wo = (h - 1) // stride + 1, (w - 1) // stride + 1
    silu = c["silu"]
    out = torch.empty((b, ho, wo, c["cout"]),
                      dtype=torch.int8 if silu else torch.int32,
                      device=x.device)
    if silu:
        consts = [c["r1"], c["s1"], c["r2"], c["s2"], sig.values]
        tab_lo, tab_n = sig.lo, sig.values.numel()
    else:   # the plain epilogue reads none of them
        consts = [c["b"]] * 5
        tab_lo, tab_n = 0, 0
    wmap = _weight_map(c)
    args = [x.data_ptr(), int(x.dtype == torch.int16),
            c["w_packed"].data_ptr(), ctypes.addressof(wmap),
            tile_n(c["cout"]), c["b"].data_ptr()] \
        + [t.data_ptr() for t in consts] \
        + [tab_lo, tab_n, out.data_ptr(), int(silu), b, h, w, cin, c["cout"]]
    if name == "conv3x3":
        args.append(stride)
    args += [qmax, _stream(x)]
    rc = kernel(name, f"ayq_{name}")(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
    LAUNCHES[name] += 1
    LAUNCHES[conv_loader(x, cin)] += 1
    return out


def conv1x1(x: torch.Tensor, c: Dict, sig: DeviceLut = None,
            qmax: int = 127) -> torch.Tensor:
    """1x1 conv + epilogue over NHWC int8/int16 rows (replaces
    pallas_ops.fused_conv1x1). Returns NHWC int8 (SiLU) or int32."""
    if c["kernel"] != 1 or c["stride"] != 1 or c["padding"] != 0:
        raise ValueError("conv1x1 takes 1x1 convs at stride 1, no padding")
    if _on_cpu(x):
        return conv_plain(x, c, sig, qmax)
    return _launch_conv("conv1x1", x, c, sig, qmax)


def conv3x3(x: torch.Tensor, c: Dict, sig: DeviceLut = None,
            qmax: int = 127) -> torch.Tensor:
    """3x3 pad-1 conv at stride 1 or 2 + epilogue, as an implicit GEMM
    (replaces pallas_ops.fused_conv3x3). Returns NHWC int8 or int32."""
    if c["kernel"] != 3 or c["padding"] != 1 or c["stride"] not in (1, 2):
        raise ValueError("conv3x3 takes 3x3 pad-1 convs at stride 1 or 2")
    if _on_cpu(x):
        return conv_plain(x, c, sig, qmax)
    return _launch_conv("conv3x3", x, c, sig, qmax)


def _launch_postconv(name: str, hi, lo, consts, sig, qmax: int,
                     axis: int) -> torch.Tensor:
    from alpha_yolo_quant_torch.runtime._build import kernel

    silu = name == "postconv_silu"
    if hi.dtype != torch.float32 or lo.dtype != torch.float32:
        raise TypeError(f"{name}: hi and lo must be float32")
    if hi.shape != lo.shape or not (hi.is_contiguous()
                                    and lo.is_contiguous()):
        raise ValueError(f"{name}: hi and lo must be contiguous, one shape")
    if not 0 <= axis < hi.dim():
        raise ValueError(f"{name}: channel axis {axis} of a {hi.dim()}-d "
                         "tensor")
    n_ch = hi.shape[axis]
    for t in consts:
        if t.dtype != torch.int32 or t.shape != (n_ch,) \
                or t.device != hi.device or lo.device != hi.device:
            raise ValueError(f"{name}: per-channel constants must be "
                             f"int32 ({n_ch},) on {hi.device}")
    if silu:
        _check_table(name, sig, qmax)
        tab, tab_lo, tab_n = sig.values, sig.lo, sig.values.numel()
        consts = list(consts)
    else:   # the plain epilogue reads only the bias
        tab, tab_lo, tab_n = consts[0], 0, 0
        consts = [consts[0]] * 5
    inner = 1
    for d in hi.shape[axis + 1:]:
        inner *= d
    out = torch.empty(hi.shape, dtype=torch.int8 if silu else torch.int32,
                      device=hi.device)
    rc = kernel("postconv", "ayq_postconv")(
        hi.data_ptr(), lo.data_ptr(), *[t.data_ptr() for t in consts],
        tab.data_ptr(), tab_lo, tab_n, out.data_ptr(), int(silu),
        hi.numel(), n_ch, inner, qmax, _stream(hi))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
    LAUNCHES[name] += 1
    return out


def postconv_silu(hi: torch.Tensor, lo: torch.Tensor, bias, r1, s1, r2, s2,
                  sig: DeviceLut, qmax: int = 127,
                  axis: int = 1) -> torch.Tensor:
    """acc = 16*hi + lo + bias from the two float32 nibble-split partial
    convs, then the SiLU requant chain -> int8 (replaces
    pallas_ops.fused_postconv_silu). Per-channel (C,) int32 constants
    along ``axis``: 1 for the JAX function's NCHW, 3 for NHWC."""
    if _on_cpu(hi):
        return postconv_silu_plain(hi, lo, bias, r1, s1, r2, s2, sig, qmax,
                                   axis)
    return _launch_postconv("postconv_silu", hi, lo, (bias, r1, s1, r2, s2),
                            sig, qmax, axis)


def postconv_plain(hi: torch.Tensor, lo: torch.Tensor, bias,
                   axis: int = 1) -> torch.Tensor:
    """acc = 16*hi + lo + bias -> int32 (replaces
    pallas_ops.fused_postconv_plain: the head's raw accumulators)."""
    if _on_cpu(hi):
        return postconv_plain_plain(hi, lo, bias, axis)
    return _launch_postconv("postconv_plain", hi, lo, (bias,), None, 127,
                            axis)


def _check_requant(name: str, t: torch.Tensor, rq) -> None:
    """The kernel requantizes in 32 bits: exact, and equal to the plain
    version, while |r * x| < 2^31 for every value x of t's dtype."""
    if rq is None:
        return
    r, s = rq
    amax = 2 ** (8 * t.element_size() - 1)
    if not 1 <= s <= 32 or abs(r) * amax >= 2 ** 31:
        raise ValueError(f"{name}: requant (r={r}, s={s}) of {t.dtype} "
                         "needs 1 <= s <= 32 and |r| * 2^(bits-1) < 2^31")


def _check_glue(name: str, srcs: Sequence[torch.Tensor],
                requants: Sequence, dtype: torch.dtype) -> None:
    if dtype not in _ACT_TYPES:
        raise TypeError(f"{name}: output must be int8 or int16, got {dtype}")
    lead = srcs[0].shape[:3]
    for t, rq in zip(srcs, requants):
        if t.dtype not in _ACT_TYPES:
            raise TypeError(f"{name}: sources must be int8 or int16, got "
                            f"{t.dtype}")
        if t.dim() != 4 or not t.is_contiguous() or t.shape[:3] != lead:
            raise ValueError(f"{name}: need contiguous NHWC sources of one "
                             f"(B, H, W), got {tuple(t.shape)}")
        if t.device != srcs[0].device:
            raise ValueError(f"{name}: sources on {t.device} and "
                             f"{srcs[0].device}")
        _check_requant(name, t, rq)


def _launch_glue(name: str, parts, out: torch.Tensor, qmax: int,
                 bound: Optional[int]) -> torch.Tensor:
    """One launch over the non-empty ``parts``: (src, base or None, rows,
    cols, out element offset, out row stride, (r, s) or None) each. No
    part holding an element: no launch, nothing counted."""
    from alpha_yolo_quant_torch.runtime._build import kernel

    parts = [p for p in parts if p[2] * p[3] > 0]
    if not parts:
        return out
    n = len(parts)
    ptrs = (ctypes.c_void_p * (3 * n))()
    rows = (ctypes.c_longlong * n)()
    meta = (ctypes.c_int * (7 * n))()
    for i, (src, base, nrow, cols, out_off, stride, rq) in enumerate(parts):
        ptrs[3 * i] = src.data_ptr()
        ptrs[3 * i + 1] = None if base is None else base.data_ptr()
        ptrs[3 * i + 2] = out.data_ptr() + out_off * out.element_size()
        rows[i] = nrow
        r, s = rq if rq is not None else (0, 1)
        meta[7 * i:7 * i + 7] = [
            cols, stride, int(src.dtype == torch.int16),
            int(base is not None and base.dtype == torch.int16),
            int(rq is not None), r, s]
    rc = kernel("glue", "ayq_requant_combine")(
        n, ptrs, rows, meta, int(out.dtype == torch.int16), qmax,
        int(bound is not None), 0 if bound is None else bound,
        _stream(out))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
    LAUNCHES[name] += 1
    return out


def residual_add(src: torch.Tensor, base: torch.Tensor, r: int, s: int,
                 qmax: int, bound: Optional[int],
                 dtype: torch.dtype) -> torch.Tensor:
    """A ResidualAddNode: requant(src, r, s) + base, clipped to +-bound if
    given, cast to dtype, as one launch of csrc/glue.cu (the plain version
    on a CPU tensor)."""
    if _on_cpu(src):
        return residual_add_plain(src, base, r, s, qmax, bound, dtype)
    return _launch_add(src, base, r, s, qmax, bound, dtype)


def _launch_add(src, base, r, s, qmax, bound, dtype) -> torch.Tensor:
    _check_glue("glue_add", [src, base], [(r, s), None], dtype)
    if base.shape != src.shape:
        raise ValueError(f"glue_add: base {tuple(base.shape)} and source "
                         f"{tuple(src.shape)} differ")
    if bound is not None and not 0 <= bound < 2 ** 31:
        raise ValueError(f"glue_add: clip bound {bound} out of int32")
    out = torch.empty(src.shape, dtype=dtype, device=src.device)
    b, h, w, c = src.shape
    return _launch_glue("glue_add", [(src, base, b * h * w, c, 0, c, (r, s))],
                        out, qmax, bound)


def concat(srcs: Sequence[torch.Tensor],
           requants: Sequence[Optional[Tuple[int, int]]], qmax: int,
           dtype: torch.dtype) -> torch.Tensor:
    """A ConcatNode: each NHWC source, requantized where it has an (r, s),
    cast to dtype and written at its channel offset, all sources in one
    launch of csrc/glue.cu (the plain version on a CPU tensor)."""
    if _on_cpu(srcs[0]):
        return concat_plain(srcs, requants, qmax, dtype)
    return _launch_concat(srcs, requants, qmax, dtype)


def _launch_concat(srcs, requants, qmax, dtype) -> torch.Tensor:
    if not 1 <= len(srcs) <= MAX_SOURCES or len(requants) != len(srcs):
        raise ValueError(f"glue_concat: {len(srcs)} sources and "
                         f"{len(requants)} requants; the kernel takes 1 to "
                         f"{MAX_SOURCES} sources, a requant or None each")
    _check_glue("glue_concat", srcs, requants, dtype)
    b, h, w = srcs[0].shape[:3]
    ctot = sum(t.shape[3] for t in srcs)
    out = torch.empty((b, h, w, ctot), dtype=dtype, device=srcs[0].device)
    parts, off = [], 0
    for t, rq in zip(srcs, requants):
        parts.append((t, None, b * h * w, t.shape[3], off, ctot, rq))
        off += t.shape[3]
    return _launch_glue("glue_concat", parts, out, qmax, None)


def dwconv3x3(x: torch.Tensor, c: Dict, sig: DeviceLut,
              qmax: int = 127) -> torch.Tensor:
    """A depthwise 3x3 pad-1 stride-1 conv + the SiLU epilogue (or, with
    unit_lut, the plain requant) over int8 NHWC, one launch of
    csrc/dwconv.cu (the plain version on a CPU tensor). Returns int8
    NHWC."""
    if _on_cpu(x):
        return dwconv3x3_plain(x, c, sig, qmax)
    from alpha_yolo_quant_torch.runtime._build import kernel

    if x.dtype != torch.int8:
        raise TypeError(f"dwconv: int8 input only, got {x.dtype} (no wide "
                        "edge reaches a depthwise conv)")
    if x.dim() != 4:
        raise ValueError(f"dwconv: need NHWC, got {tuple(x.shape)}")
    b, h, w, ch = x.shape
    if not x.is_contiguous() or ch != c["cout"] or ch % CHUNK \
            or x.data_ptr() % 16:
        raise ValueError(f"dwconv: need a contiguous, 16-byte aligned NHWC "
                         f"tensor of {c['cout']} channels, a multiple of "
                         f"{CHUNK}; got {tuple(x.shape)}")
    if c["w_taps"].device != x.device:
        raise ValueError(f"dwconv: weights on {c['w_taps'].device}, input "
                         f"on {x.device}")
    _check_table("dwconv", sig, qmax)
    out = torch.empty_like(x)
    rc = kernel("dwconv", "ayq_dwconv3x3")(
        x.data_ptr(), c["w_taps"].data_ptr(), c["b"].data_ptr(),
        *[c[f].data_ptr() for f in ("r1", "s1", "r2", "s2")],
        sig.values.data_ptr(), sig.lo, sig.values.numel(), out.data_ptr(),
        b, h, w, ch, qmax, _stream(x))
    if rc != 0:
        raise RuntimeError(f"dwconv launch failed: cudaError_t {rc}")
    LAUNCHES["dwconv"] += 1
    return out


def attention(qkv: torch.Tensor, a: Dict, qmax: int = 127):
    """An attention node over int8 NHWC qkv, one launch of csrc/attn.cu
    for all images and heads (the plain version on a CPU tensor).
    Returns (out, v), int8 NHWC, channel h * head_dim + d."""
    if _on_cpu(qkv):
        return attention_plain(qkv, a, qmax)
    from alpha_yolo_quant_torch.runtime._build import kernel

    b, hh, ww, c = qkv.shape
    heads, kd, hd = a["heads"], a["key_dim"], a["head_dim"]
    n = hh * ww
    if (kd, hd) != ATTN_DIMS:
        raise ValueError(f"attn: key_dim {kd} and head_dim {hd}; the kernel "
                         f"takes {ATTN_DIMS}")
    if qkv.dtype != torch.int8 or not qkv.is_contiguous() \
            or c != heads * (2 * kd + hd) or qkv.data_ptr() % 16:
        raise ValueError(f"attn: need contiguous, 16-byte aligned int8 NHWC "
                         f"qkv of {heads * (2 * kd + hd)} channels, got "
                         f"{qkv.dtype} {tuple(qkv.shape)}")
    if not 1 <= n <= MAX_ATTN_N:
        raise ValueError(f"attn: {n} pixels, the kernel takes 1 to "
                         f"{MAX_ATTN_N}")
    (lr, ls), (orr, os_) = a["logit"], a["out"]
    # the logit requant runs in 32 bits: |r * q^T k| < 2^31
    if not (1 <= ls <= 31 and 1 <= os_ <= 31
            and abs(lr) * kd * 128 ** 2 < 2 ** 31 and abs(orr) * 128 < 2 ** 31):
        raise ValueError(f"attn: requants ({lr}, {ls}), ({orr}, {os_}) out "
                         "of the kernel's 32-bit range")
    exp = a["exp"]
    if (exp.lo, exp.hi) != (-255, 0) or exp.values.device != qkv.device:
        raise ValueError("attn: the exponent table covers [-255, 0] on the "
                         "input's device")
    out = torch.empty((b, hh, ww, heads * hd), dtype=torch.int8,
                      device=qkv.device)
    v = torch.empty_like(out)
    rc = kernel("attn", "ayq_attention")(
        qkv.data_ptr(), out.data_ptr(), v.data_ptr(), exp.values.data_ptr(),
        b, n, heads, lr, ls, orr, os_, qmax, _stream(qkv))
    if rc != 0:
        raise RuntimeError(f"attn launch failed: cudaError_t {rc}")
    LAUNCHES["attn"] += 1
    return out, v


def sigma_probe(sig: DeviceLut) -> torch.Tensor:
    """The epilogue's sigmoid lookup evaluated over the LUT domain
    [lo, hi] (int32)."""
    if _on_cpu(sig.values):
        return sigma_probe_plain(sig)
    from alpha_yolo_quant_torch.runtime._build import kernel

    n = sig.values.numel()
    if n > MAX_LUT:
        raise ValueError(f"sigma_probe: table of {n} > {MAX_LUT} entries")
    out = torch.empty(n, dtype=torch.int32, device=sig.values.device)
    rc = kernel("sigma_probe", "ayq_sigma_probe")(
        sig.values.data_ptr(), sig.lo, n, out.data_ptr(), _stream(out))
    if rc != 0:
        raise RuntimeError(f"sigma_probe launch failed: cudaError_t {rc}")
    LAUNCHES["sigma_probe"] += 1
    return out


def sigma_corrections(sig: DeviceLut) -> Tuple[Tuple[int, int], ...]:
    """Fixups ``(index, value)`` wherever the device sigmoid differs from
    ``Lut.values`` (replaces pallas_ops.pallas_sigma_corrections). The
    kernels read the table itself, so this is ``()``."""
    got = sigma_probe(sig).cpu().numpy()
    want = sig.lut.values
    bad = np.nonzero(got != want)[0]
    return tuple((int(i + sig.lo), int(want[i])) for i in bad)
