"""Wrappers of the Hopper kernels (counterpart of
alpha_yolo_quant_tpu/runtime/pallas_ops.py).

Each kernel has its plain PyTorch version in this module and a launch
count in ``LAUNCHES``. A wrapper given a CPU tensor runs the plain
version; given a CUDA tensor it launches the kernel (runtime/csrc, built
on first use by runtime/_build.py) or raises. There is no fallback from a
failed launch.

Activations are NHWC. A conv's plan entry (interpreter.device_plan) holds
its weights twice: OIHW float64 for the plain version and the kernel's
packed tap-major int8 words (pack_weights).
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
LAUNCHES: Dict[str, int] = {"conv1x1": 0, "conv3x3": 0, "sigma_probe": 0}

K_TILE = 32        # conv_igemm.cuh BK: packed weight depth is padded to it
MAX_LUT = 256      # epilogue.cuh kMaxLut
_ACT_TYPES = (torch.int8, torch.int16)


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pack_weights(w_q: np.ndarray) -> np.ndarray:
    """OIHW integer weights -> the kernels' int32 words (Kp/4, O): depth
    k = (dy*kw + dx)*Cin + c, zero-padded to a multiple of K_TILE, four
    int8 weights per little-endian word."""
    o = w_q.shape[0]
    wk = np.ascontiguousarray(w_q.transpose(0, 2, 3, 1)).reshape(o, -1)
    kp = -(-wk.shape[1] // K_TILE) * K_TILE
    wk = np.pad(wk, ((0, 0), (0, kp - wk.shape[1]))).astype(np.int8)
    return np.ascontiguousarray(wk.view("<i4").T)


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


# --------------------------------------------------------------- kernels

def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


def _check_conv(name: str, x: torch.Tensor, c: Dict, sig, qmax: int):
    if x.dtype not in _ACT_TYPES:
        raise TypeError(f"{name}: activations must be int8 or int16, "
                        f"got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"{name}: need a contiguous NHWC tensor")
    if x.shape[3] != c["cin"]:
        raise ValueError(f"{name}: {x.shape[3]} input channels, weights "
                         f"take {c['cin']}")
    if c["cin"] % 4 == 0 and x.data_ptr() % (4 * x.element_size()):
        # the vector path loads four channels as one aligned word
        raise ValueError(f"{name}: input not aligned to 4 channels")
    if c["w_packed"].device != x.device:
        raise ValueError(f"{name}: weights on {c['w_packed'].device}, "
                         f"input on {x.device}")
    if c["silu"]:
        n = sig.values.numel()
        if n > MAX_LUT or sig.lo > -qmax or sig.hi < qmax:
            raise ValueError(f"{name}: sigmoid table [{sig.lo}, {sig.hi}] "
                             f"must cover +-{qmax} in <= {MAX_LUT} entries")


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
    if c["kernel"] != 1:
        raise ValueError("conv1x1 takes 1x1 convs")
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
