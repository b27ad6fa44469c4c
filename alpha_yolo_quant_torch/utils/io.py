"""Calibration-file IO in the reference's text formats (counterpart of
alpha_yolo_quant_tpu/utils/io.py, text logic unchanged, so both packages
write the same bytes and read each other's files).

max_a.txt lines are "name: value" (parsed by reference utils/max_a.py:1-7,
written by utils/stage_5_common_func.py:11-26 with python float repr).
max_a_all.txt holds the raw per-image statistic lists (reference
stage_4.py:1007-1011 / stage_5.py:12-28).
"""

from __future__ import annotations

from typing import Dict, List


def write_max_a(path: str, max_a: Dict[str, float]) -> None:
    with open(path, "w") as f:
        f.write("start: 1.0\n")
        for name, value in max_a.items():
            if name == "start":
                continue
            f.write(f"{name}: {value}\n")


def read_max_a(path: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            name, value = line.split(": ")
            out[name] = float(value)
    return out


def write_max_a_all(path: str, records: Dict[str, List[float]]) -> None:
    with open(path, "w") as f:
        for name, values in records.items():
            f.write(f"{name}: {[float(v) for v in values]}\n")


def read_max_a_all(path: str) -> Dict[str, List[float]]:
    """Parse per-image statistic lists, the port's and the reference's.

    The port writes plain float lists. The reference's stage-4 dump writes
    the repr of a list of torch scalar tensors, "conv_p1: [tensor(0.9686,
    device='cuda:0'), tensor(...), ...]", rounded to torch's 4-decimal
    print precision, and its stage 5 reads exactly those rounded values
    (stage_5.py:12-26: strip [], split ', ', strip 'tensor('/')', drop
    device fragments). This parser does the same, so a reference-made
    calibration tree resumes here with its rounding."""
    out: Dict[str, List[float]] = {}
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            name, rest = line.split(": ", 1)
            rest = rest.replace("[", "").replace("]", "")
            vals = []
            for frag in rest.split(", "):
                frag = frag.replace("tensor(", "").replace(")", "")
                if not frag.strip() or "device=" in frag:
                    continue
                vals.append(float(frag))
            out[name] = vals
    return out
