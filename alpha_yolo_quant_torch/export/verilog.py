"""Verilog-literal text emitters.

Format contract (reference quantisation/utils/save_weights.py:45-155):
  * ``bit_converter`` renders ``<width>'b<binary>`` literals; negative values
    are MAGNITUDE binaries with a '-' folded into the width prefix
    (bin(-5) -> '-0b101' -> "-7'b0000101" for K=8) — not two's complement.
  * weights/activations budget K bits (K-1 magnitude), bias 18 bits,
    rescale/shift K bits; over-budget values print a loud warning.
  * weight files carry ``weight[i] = ...; // value`` then ``weight_bias[i]``,
    activation files ``pixel[i] = ...`` grouped per channel, with
    ``rescale[c]`` / ``shift[c]`` appended.

Counterpart of alpha_yolo_quant_tpu/export/verilog.py, numpy logic unchanged;
both packages write the same bytes and read each other's files.
"""

from __future__ import annotations

import os

import numpy as np


def bit_converter(final_file_name: str, k: int, value, element: str,
                  bias_bits: int = 18, warn=print) -> str:
    value = int(value)
    raw = bin(value)
    prefix, bits = raw.split("b")
    if element == "bias":
        zeroes = "0" * (bias_bits - len(bits))
        if bias_bits - len(bits) < 0:
            warn(f"BIAS MORE THAN {bias_bits} BIT! {bits} {final_file_name}")
        prefix = (prefix[0] + str(bias_bits) if len(prefix) == 2
                  else str(bias_bits))
    elif element == "rescale":
        zeroes = "0" * (k - len(bits))
        if k - len(bits) < 0:
            warn(f"RESCALE MORE THAN {k} BIT! {bits} {final_file_name}")
        prefix = str(k)
    else:
        zeroes = "0" * (k - len(bits) - 1)
        if (k - len(bits) - 1) < 0:
            warn(f"MORE THAN {k} BIT! {bits} {final_file_name}")
        prefix = prefix[0] + str(k - 1) if len(prefix) == 2 else str(k - 1)
    return f"{prefix}'b{zeroes}{bits}"


def _native():
    """The native emitter, or None without a C++ toolchain; the Python
    loops below write the same bytes."""
    from alpha_yolo_quant_torch.native import fastwriter

    return fastwriter()


def save_txt_weight(conv: np.ndarray, bias: np.ndarray, file_name: str,
                    type_: str, k: int, dir_names: str, warn=print) -> str:
    """Per-layer weight + bias Verilog text
    (reference utils/save_weights.py:90-109). ``bias`` is the (1,C,1,1)
    layout the reference writes."""
    final = f"{file_name}_type_{type_}_bit_{k}_shape_{tuple(conv.shape)}"
    path = os.path.join(dir_names, "quant_weights_yolov8n", f"{final}.txt")
    lib = _native()
    if lib is not None:
        import ctypes

        wq = np.ascontiguousarray(conv, np.int64)
        bq = np.ascontiguousarray(bias, np.int64).reshape(-1)
        n_over = lib.write_txt_weights(
            path.encode(), wq.ctypes.data_as(
                ctypes.POINTER(ctypes.c_int64)),
            *map(int, wq.shape),
            bq.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            bq.size, k, 18)
        if n_over > 0:
            warn(f"{final}: {n_over} values over bit budget")
        return path
    with open(path, "w") as f:
        i = 0
        for b in range(conv.shape[0]):
            f.write(f"\n//   Batch: {b}\n\n")
            for c in range(conv.shape[1]):
                for h in range(conv.shape[2]):
                    for w in range(conv.shape[3]):
                        v = conv[b, c, h, w]
                        f.write(f"weight[{i}] = "
                                f"{bit_converter(final, k, v, 'weight', warn=warn)};"
                                f" // {v}\n")
                        i += 1
                f.write("\n")
        f.write("\n\n")
        i = 0
        for b in range(bias.shape[0]):
            for c in range(bias.shape[1]):
                for h in range(bias.shape[2]):
                    for w in range(bias.shape[3]):
                        v = bias[b, c, h, w]
                        f.write(f"weight_bias[{i}] = "
                                f"{bit_converter(final, k, v, 'bias', warn=warn)};"
                                f" // {v}\n")
                        i += 1
    return path


def _act_file(file_name: str, type_: str, k: int, shape, silu: bool) -> str:
    sub = "silu" if silu else "conv2d"
    return (f"quant_activations/{sub}/"
            f"{file_name}_type_{type_}_bit_{k}_shape_{tuple(shape)}")


def save_txt_activations(arr: np.ndarray, file_name: str, dir_names: str,
                         type_: str, k: int, silu: bool = False,
                         warn=print) -> str:
    """Golden activation vectors for the RTL testbench
    (reference utils/save_weights.py:112-126)."""
    final = _act_file(file_name, type_, k, arr.shape, silu)
    path = os.path.join(dir_names, f"{final}.txt")
    lib = _native()
    if lib is not None:
        import ctypes

        a = np.ascontiguousarray(arr, np.int64)
        n_over = lib.write_txt_activations(
            path.encode(),
            a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            *map(int, a.shape), k)
        if n_over > 0:
            warn(f"{final}: {n_over} values over bit budget")
        return path
    with open(path, "w") as f:
        i = 0
        for b in range(arr.shape[0]):
            for c in range(arr.shape[1]):
                f.write(f"\n//   Channel: {c}\n\n")
                for h in range(arr.shape[2]):
                    for w in range(arr.shape[3]):
                        v = arr[b, c, h, w]
                        f.write(f"pixel[{i}] = "
                                f"{bit_converter(final, k, v, 'activ', warn=warn)};"
                                f" // {v}\n")
                        i += 1
                f.write("\n")
    return path


def save_txt_rescale_shift(arr: np.ndarray, rescale, shift, file_name: str,
                           dir_names: str, type_: str, k: int,
                           silu: bool = False, warn=print) -> str:
    """Append per-channel rescale/shift to the activation file
    (reference utils/save_weights.py:129-155). Accepts scalar or (1,C,1,1)."""
    final = _act_file(file_name, type_, k, arr.shape, silu)
    r = np.asarray(rescale)
    s = np.asarray(shift)
    if r.ndim < 2:
        r = r.reshape(1, -1, 1, 1)
        s = s.reshape(1, -1, 1, 1)
    path = os.path.join(dir_names, f"{final}.txt")
    with open(path, "a") as f:
        f.write("\n")
        for c in range(r.shape[1]):
            f.write(f"rescale[{c}] = "
                    f"{bit_converter(final, k, r[0, c, 0, 0], 'rescale', warn=warn)};"
                    f" // {r[0, c, 0, 0]}\n")
        f.write("\n")
        for c in range(s.shape[1]):
            f.write(f"shift[{c}] = "
                    f"{bit_converter(final, k, s[0, c, 0, 0], 'rescale', warn=warn)};"
                    f" // {s[0, c, 0, 0]}\n")
    return path


def save_lut_table(lut, name: str, path: str) -> None:
    """LUT text table, reference format (utils/silu.py:46-49:
    '// SIGMOID TABLE FOR {k} BIT' then '{i} = {value}' lines with the raw
    float reprs)."""
    with open(path, "w") as f:
        f.write(f"// {name.upper()} TABLE FOR {lut.bits} BIT\n\n")
        for i in range(lut.lo, lut.hi + 1):
            f.write(f"{i} = {lut.raw[i - lut.lo]}\n")
