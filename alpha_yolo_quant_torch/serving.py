"""Request seam of the serving path (counterpart of the slice of
alpha_yolo_quant_tpu/serving.py that build_int_pipeline needs)."""

from __future__ import annotations

from typing import Sequence


def split_by_sizes(tree, sizes: Sequence[int]) -> tuple:
    """Split every tensor of ``tree`` (a tensor, or a tuple/list/dict of
    them, nested) along dim 0 into consecutive row blocks of ``sizes``."""

    def take(t, off, s):
        if isinstance(t, dict):
            return {k: take(v, off, s) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(take(v, off, s) for v in t)
        return t[off:off + s]

    parts, off = [], 0
    for s in sizes:
        parts.append(take(tree, off, s))
        off += s
    return tuple(parts)
