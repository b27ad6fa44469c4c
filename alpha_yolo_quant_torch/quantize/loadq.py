"""Rebuild a runnable QuantizedModel from exported artifacts.

The stage-8 load path (reference stage_8_torch.py:262-268, 965-968): the
runtime is reconstructed from the per-layer weight pickles + stored
bias_scales + max_a.txt, without re-running the quantizer. Every requant
constant derives deterministically from acc_scale + max_a, so the loaded
plan is bit-identical to the originally built one
(tests/test_torch_export.py).

Counterpart of alpha_yolo_quant_tpu/quantize/loadq.py, numpy logic unchanged;
both packages write the same bytes and read each other's files.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.export.pickles import load_gz_pickle, load_scales
from alpha_yolo_quant_torch.models.graph import Graph, build_yolov8_graph
from alpha_yolo_quant_torch.quantize.transform import (
    QuantizedModel, build_quantized_model,
)
from alpha_yolo_quant_torch.utils.io import read_max_a


def model_from_artifacts(out_dir: str, cfg: QuantConfig,
                         graph: Optional[Graph] = None) -> QuantizedModel:
    """Load integer weights + scales + calibration from an artifact
    directory and rebuild the full plan."""
    graph = graph or build_yolov8_graph(cfg)
    max_a = read_max_a(os.path.join(out_dir, "results", "max_a.txt"))
    wp = os.path.join(out_dir, "weights_pickle")
    scales = load_scales(out_dir)

    override = {}
    for node in graph.convs():
        w_q = load_gz_pickle(os.path.join(wp, f"{node.name}_conv.pickle"))
        b_q = load_gz_pickle(os.path.join(wp, f"{node.name}_bias.pickle"))
        override[node.name] = (w_q, b_q, scales[node.name])

    params = {"dfl": {"w": dfl_weights_from_artifacts(out_dir)}}
    dfl_override = None
    dfl_q_path = os.path.join(wp, "dfl_conv.pickle")
    if cfg.full_quant and os.path.exists(dfl_q_path) and "dfl" in scales:
        # full-quant trees store the quantized dfl + its scale; rebuild
        # from the stored values rather than re-quantizing (see
        # build_quantized_model dfl_override)
        dfl_override = (np.int64(load_gz_pickle(dfl_q_path)),
                        float(np.asarray(scales["dfl"]).reshape(-1)[0]))
    return build_quantized_model(graph, params, max_a, cfg,
                                 weights_override=override,
                                 dfl_override=dfl_override)


def dfl_weights_from_artifacts(out_dir: str) -> np.ndarray:
    """Float DFL weights for the partial-quant decode.

    Full-quant trees don't write weights_pickle/dfl.pickle (export_all
    only emits it when the head stays float); the checkpoint dfl is the
    frozen arange(16) (reference stage_2.py:471-475), so fall back to it
    — the full-quant decode never reads this value anyway."""
    p = os.path.join(out_dir, "weights_pickle", "dfl.pickle")
    if os.path.exists(p):
        return np.asarray(load_gz_pickle(p), np.float32)
    return np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1)


def model_from_packed_state_dict(out_dir: str, cfg: QuantConfig,
                                 graph: Optional[Graph] = None
                                 ) -> QuantizedModel:
    """The exact stage-8 load interface: QUANT_WEIGHTS_{K} packed state
    dict + bias_scales/ + max_a.txt -> runnable model (reference
    stage_8_torch.py:262-268, 965-968)."""
    from alpha_yolo_quant_torch.export.pickles import load_packed_state_dict

    graph = graph or build_yolov8_graph(cfg)
    max_a = read_max_a(os.path.join(out_dir, "results", "max_a.txt"))
    sd = load_packed_state_dict(
        os.path.join(out_dir, "results", f"QUANT_WEIGHTS_{cfg.k}.pickle"))
    scales = load_scales(out_dir)
    override = {}
    for node in graph.convs():
        override[node.name] = (np.int64(sd[f"{node.key}.weight"]),
                               np.int64(sd[f"{node.key}.bias"]),
                               scales[node.name])
    params = {"dfl": {"w": np.asarray(sd["dfl.weight"])}}   # dtype-native
    dfl_override = None
    if cfg.full_quant:
        # full-quant packed dicts carry the QUANTIZED dfl (see
        # export.pickles.packed_state_dict); its scale lives in
        # bias_scales/dfl_scale.pickle (stage_8_torch_full_quant.py:1233).
        # Guard against loading a PARTIAL tree under a full-quant cfg:
        # its dfl.weight is the float arange and there is no dfl scale —
        # int-truncating it would silently build a wrong head plan.
        dfl_w = np.asarray(sd["dfl.weight"])
        if "dfl" not in scales or not np.array_equal(dfl_w,
                                                     np.round(dfl_w)):
            raise FileNotFoundError(
                f"{out_dir}: full_quant=True but the packed state dict /"
                " bias_scales tree was exported partial-quant (no"
                " quantized dfl + dfl_scale.pickle); re-export with"
                " --full-quant or load with full_quant=False")
        dfl_override = (np.int64(dfl_w),
                        float(np.asarray(scales["dfl"]).reshape(-1)[0]))
    return build_quantized_model(graph, params, max_a, cfg,
                                 weights_override=override,
                                 dfl_override=dfl_override)
