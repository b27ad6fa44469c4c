"""Float parameters: random initialisation, the checkpoint slot order, and
the move onto a torch device.

Fused parameters are a flat dict  key -> {'w': f32[O,I,kh,kw], 'b': f32[O]}
(plus 'dfl' -> {'w': f32[1,16,1,1]}), keyed by the reference state-dict
prefixes. ``init_params``, ``raw_param_slots`` and ``load_raw_from_values``
are the port's own copies of alpha_yolo_quant_tpu/models/params.py, numpy
logic unchanged: the same seed gives the same arrays in both packages,
which is how weights are carried across.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from alpha_yolo_quant_torch.models.graph import ConvNode, Graph


def conv_has_bn(node: ConvNode) -> bool:
    """In the unfused model every SiLU conv carries a BatchNorm; the detect
    final 1x1 convs ('.4') have a plain bias instead (reference
    stage_2.py:52-66), and DFL has neither."""
    return node.silu


def registration_conv_order(graph: Graph) -> List[ConvNode]:
    """Conv nodes in the reference custom module's REGISTRATION order — which
    is also, positionally, the ultralytics checkpoint's tensor order (the
    reference's remap is a blind zip of the two: stage_1.py:775-783).

    Registration order differs from graph/forward order in two places
    (reference stage_1.py:285-386):
      * within each C2F block the two 1x1 convs register first
        (``cf2_conv_{i}``, ``cf2_conv_{i+1}``) and the bottleneck convs
        after — the forward runs conv_0, bottlenecks, conv_1 (this mirrors
        ultralytics C2f: cv1, cv2, then the m ModuleList);
      * the six detect branches register as the three "up" (box) branches
        followed by the three "down" (cls) branches — the forward/graph
        interleaves up/down per level (mirrors ultralytics Detect: the cv2
        ModuleList then the cv3 ModuleList).
    """
    def module(node: ConvNode) -> str:
        return node.key.split(".")[0]

    def c2f_block(node: ConvNode):
        # C2F conv names: '<block>_conv_0' / '<block>_conv_1' /
        # '<block>_bottle_<j>' with block in {C2F_2, ..., C2F_21}
        if node.name.startswith("C2F_"):
            for marker in ("_conv_0", "_conv_1", "_bottle_"):
                i = node.name.find(marker)
                if i >= 0:
                    return node.name[:i]
        return None

    groups: Dict[str, List[ConvNode]] = {}   # insertion-ordered
    for node in graph.convs():
        blk = c2f_block(node)
        groups.setdefault(blk if blk is not None else module(node),
                          []).append(node)

    ordered: List[ConvNode] = []
    head_up: List[ConvNode] = []
    head_down: List[ConvNode] = []
    for label, nodes in groups.items():
        if label.startswith("detect_") and label.endswith("_up"):
            head_up.extend(nodes)
        elif label.startswith("detect_") and label.endswith("_down"):
            head_down.extend(nodes)
        elif len(nodes) > 1 and nodes[0].name.startswith("C2F_"):
            # graph order: conv_0, bottles..., conv_1 -> registration
            # order: conv_0, conv_1, bottles...
            ordered.append(nodes[0])
            ordered.append(nodes[-1])
            ordered.extend(nodes[1:-1])
        else:
            ordered.extend(nodes)
    ordered.extend(head_up)
    ordered.extend(head_down)
    return ordered


def raw_param_slots(graph: Graph) -> List[Tuple[str, Sequence[str]]]:
    """The ordered raw (pre-fusion) tensor slots of the model, matching both
    the custom model's state_dict order and — positionally — the ultralytics
    checkpoint's (reference stage_1.py:775-783 relies on this 1:1 order).

    The order is the module REGISTRATION order (registration_conv_order),
    NOT graph/forward order: ultralytics C2f registers cv1, cv2 before the
    bottlenecks, and Detect registers all box branches before all cls
    branches.

    Returns [(key, ('w','gamma','beta','mean','var','nbt')) | (key, ('w','b'))
             ..., ('dfl', ('w',))].
    """
    slots: List[Tuple[str, Sequence[str]]] = []
    for node in registration_conv_order(graph):
        if conv_has_bn(node):
            slots.append((node.key, ("w", "gamma", "beta", "mean", "var",
                                     "nbt")))
        else:
            slots.append((node.key, ("w", "b")))
    slots.append(("dfl", ("w",)))
    return slots


# raw state-dict tensor counts per scale, for the mismatch diagnostics
_SCALE_TENSOR_COUNTS = {355: "yolov8n or yolov8s", 475: "yolov8m",
                        595: "yolov8l or yolov8x"}


def _slot_shape(node: ConvNode, field: str):
    if field == "w":
        return (node.cout, node.cin, node.kernel, node.kernel)
    if field == "nbt":
        return ()
    return (node.cout,)


def load_raw_from_values(graph: Graph, values: Sequence[np.ndarray]) -> Dict:
    """Positional remap of a flat tensor sequence (e.g. ultralytics
    state_dict().values()) onto the raw slots, with per-slot shape
    validation — a checkpoint from a different model scale must fail with
    a diagnostic naming the first mismatched slot (the reference's blind
    zip, stage_1.py:775-783, would load it and produce garbage or a
    cryptic fusion error)."""
    slots = raw_param_slots(graph)
    n_expected = sum(len(s[1]) for s in slots)
    if len(values) != n_expected:
        hint = _SCALE_TENSOR_COUNTS.get(len(values))
        hint = f" (a {hint} checkpoint?)" if hint else ""
        raise ValueError(
            f"expected {n_expected} tensors for {graph.cfg.model}, got "
            f"{len(values)}{hint}")
    nodes = {n.key: n for n in graph.convs()}
    raw: Dict[str, Dict[str, np.ndarray]] = {}
    it = iter(values)
    for key, fields in slots:
        raw[key] = {}
        for f in fields:
            v = np.asarray(next(it))
            if key != "dfl":
                want = _slot_shape(nodes[key], f)
                if f != "nbt" and tuple(v.shape) != want:
                    raise ValueError(
                        f"checkpoint tensor for slot {key}.{f} has shape "
                        f"{tuple(v.shape)}, expected {want} — wrong model "
                        f"scale ({graph.cfg.model}) or non-ultralytics "
                        "tensor order")
            raw[key][f] = v
    if tuple(raw["dfl"]["w"].shape) != (1, 16, 1, 1):
        raise ValueError(
            f"dfl weight shape {tuple(raw['dfl']['w'].shape)} != (1,16,1,1)")
    return raw


def init_params(graph: Graph, seed: int = 0) -> Dict:
    """Random fused params for tests/benchmarks when no checkpoint is
    available. Variance-conserving gain (1/fan_in) rather than He — with
    60+ stacked SiLU convs He-init activations grow until the calibrated
    requantization becomes infeasible (shift<1, where the reference's
    rescale derivation aborts: utils/rescale_coeff.py:40-42). DFL weight is
    arange(16) like the real model (reference stage_2.py:471-475)."""
    rng = np.random.default_rng(seed)
    params: Dict[str, Dict[str, np.ndarray]] = {}
    for node in graph.convs():
        fan_in = node.cin * node.kernel * node.kernel
        w = rng.normal(0.0, np.sqrt(1.0 / fan_in),
                       size=(node.cout, node.cin, node.kernel, node.kernel))
        b = rng.normal(0.0, 0.02, size=(node.cout,))
        params[node.key] = {"w": w.astype(np.float32),
                            "b": b.astype(np.float32)}
    params["dfl"] = {"w": np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1)}
    return params


def params_to_torch(params: Dict,
                    device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{key: {'w': f32[O,I,kh,kw], 'b': f32[O]}, 'dfl': {'w': ...}} of
    numpy arrays (or tensors) -> the same structure of float32 tensors on
    device."""
    return {key: {name: torch.as_tensor(v, dtype=torch.float32,
                                        device=device)
                  for name, v in p.items()}
            for key, p in params.items()}
