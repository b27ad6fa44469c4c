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
contiguous per output channel (pack_weights).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from alpha_yolo_quant_torch.ops.intmath import requantize
from alpha_yolo_quant_torch.ops.lut import DeviceLut
from alpha_yolo_quant_torch.ops.nn import conv2d_int_exact

# kernel launches since the last reset_counts(); only a launch of the
# kernel itself counts, never a plain-version call
LAUNCHES: Dict[str, int] = {"conv1x1": 0, "conv3x3": 0, "sigma_probe": 0,
                            "postconv_silu": 0, "postconv_plain": 0,
                            "packed_conv": 0}

K_TILE = 64        # conv_igemm.cuh BK, the depth of one pipeline stage:
#                    packed weight depth is zero-padded to a multiple of it
MAX_LUT = 256      # epilogue.cuh kMaxLut: the longest sigmoid table
CHUNK = 16         # channels per cp.async copy (conv_igemm.cuh): inputs
#                    with Cin % CHUNK == 0 are read 16 bytes at a time
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


def conv_entry(w_q, b_q, stride: int, padding: int, silu: bool, device,
               r1=None, s1=None, r2=None, s2=None) -> Dict:
    """One conv's tensors in the form every wrapper here takes: weights
    for both versions, per-output-channel int32 constants, geometry."""
    w_q = np.asarray(w_q)
    c = {"w_f64": torch.as_tensor(w_q, dtype=torch.float64, device=device),
         "w_packed": torch.as_tensor(pack_weights(w_q), device=device),
         "b": torch.as_tensor(np.asarray(b_q).reshape(-1), dtype=torch.int32,
                              device=device),
         "kernel": int(w_q.shape[2]), "stride": int(stride),
         "padding": int(padding), "silu": bool(silu),
         "cin": int(w_q.shape[1]), "cout": int(w_q.shape[0])}
    if silu:
        for f, v in (("r1", r1), ("s1", s1), ("r2", r2), ("s2", s2)):
            c[f] = torch.as_tensor(np.asarray(v).reshape(-1),
                                   dtype=torch.int32, device=device)
    return c


# ---------------------------------------------------------------- plain

def conv_acc_plain(x: torch.Tensor, c: Dict) -> torch.Tensor:
    """Exact accumulator + bias, NHWC int64 (the plain conv)."""
    acc = conv2d_int_exact(x.permute(0, 3, 1, 2), c["w_f64"], c["stride"],
                           c["padding"])
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
    args = [x.data_ptr(), int(x.dtype == torch.int16),
            c["w_packed"].data_ptr(), c["b"].data_ptr()] \
        + [t.data_ptr() for t in consts] \
        + [tab_lo, tab_n, out.data_ptr(), int(silu), b, h, w, cin, c["cout"]]
    if name == "conv3x3":
        args.append(stride)
    args += [qmax, _stream(x)]
    rc = kernel(name, f"ayq_{name}")(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {rc}")
    LAUNCHES[name] += 1
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
