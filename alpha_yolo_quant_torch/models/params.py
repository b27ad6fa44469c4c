"""Float parameters: random initialisation, checkpoint loading, BatchNorm
fusion, and the move onto a torch device.

Fused parameters are a flat dict  key -> {'w': f32[O,I,kh,kw], 'b': f32[O]}
(plus 'dfl' -> {'w': f32[1,16,1,1]}), keyed by the reference state-dict
prefixes. Everything but ``params_to_torch`` is the port's own copy of
alpha_yolo_quant_tpu/models/params.py, numpy logic unchanged: the same seed
or checkpoint gives the same arrays in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from alpha_yolo_quant_torch.models.graph import (
    ConvNode, Graph, require_dense_graph,
)

BN_EPS = 1e-3  # reference stage_1.py:37 (BatchNorm2d eps=0.001)


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
    cryptic fusion error). The P6 and YOLO11 graphs have no remap yet."""
    if graph.cfg.p6:
        raise ValueError(f"{graph.cfg.model}: checkpoints load into the "
                         "three-level graphs only")
    require_dense_graph(graph, "checkpoint remap")
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


def fuse_batchnorm(graph: Graph, raw: Dict) -> Dict:
    """w' = gamma*w/sqrt(var+eps); b' = beta + gamma*(-mean)/sqrt(var+eps)
    per output channel (reference utils/batch_norm.py:25-36, eps=0.001).

    Computed in FLOAT32 with the reference's exact expression order
    (multiply by gamma, then divide by the f32 sqrt, no reciprocal
    hoist): the reference fuses the f32 state dict in f32 numpy, and a
    f64 round-trip flips one-ULP ties in the fused weights, which the
    quantizer then amplifies into off-by-one int weights."""
    fused: Dict[str, Dict[str, np.ndarray]] = {}
    for node in graph.convs():
        p = raw[node.key]
        w = np.asarray(p["w"], np.float32)
        if conv_has_bn(node):
            g = np.asarray(p["gamma"], np.float32)
            be = np.asarray(p["beta"], np.float32)
            mu = np.asarray(p["mean"], np.float32)
            var = np.asarray(p["var"], np.float32)
            den = np.sqrt(var + BN_EPS)          # f32 (weak python eps)
            fused[node.key] = {
                "w": (g[:, None, None, None] * w) / den[:, None, None,
                                                        None],
                "b": ((g * (-mu)) / den) + be,
            }
        else:
            fused[node.key] = {"w": w,
                               "b": np.asarray(p["b"], np.float32)}
    fused["dfl"] = {"w": np.asarray(raw["dfl"]["w"], np.float32)}
    return fused


def init_raw_params(graph: Graph, seed: int = 0) -> Dict:
    """Random UNFUSED params (conv + batchnorm stats) for testing the fusion
    path itself."""
    rng = np.random.default_rng(seed)
    raw: Dict[str, Dict[str, np.ndarray]] = {}
    for node in graph.convs():
        fan_in = node.cin * node.kernel * node.kernel
        # variance-conserving gain, see init_params
        w = rng.normal(0.0, np.sqrt(1.0 / fan_in),
                       size=(node.cout, node.cin, node.kernel,
                             node.kernel)).astype(np.float32)
        if conv_has_bn(node):
            raw[node.key] = {
                "w": w,
                "gamma": rng.uniform(0.5, 1.5, node.cout).astype(np.float32),
                "beta": rng.normal(0, 0.1, node.cout).astype(np.float32),
                "mean": rng.normal(0, 0.2, node.cout).astype(np.float32),
                "var": rng.uniform(0.2, 1.0, node.cout).astype(np.float32),
                "nbt": np.array(0, np.int64),
            }
        else:
            raw[node.key] = {"w": w,
                             "b": rng.normal(0, 0.02, node.cout).astype(
                                 np.float32)}
    raw["dfl"] = {"w": np.arange(16, dtype=np.float32).reshape(1, 16, 1, 1)}
    return raw


def load_torch_checkpoint(graph: Graph, path: str) -> Dict:
    """Load a checkpoint file and return RAW params.

    Accepts either a plain state_dict of tensors (torch.save of an
    OrderedDict) or, when the ultralytics package is importable, a full
    ultralytics YOLO checkpoint. ``torch.load(weights_only=True)`` is tried
    first; only a file it refuses is unpickled in full, which runs the
    file's code, so load only checkpoints you trust. The remap is
    positional, like the reference's (stage_1.py:775-783)."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    if isinstance(obj, dict) and "model" in obj and hasattr(obj["model"],
                                                            "state_dict"):
        obj = obj["model"].float().state_dict()
    values = [v.detach().cpu().numpy() if hasattr(v, "detach") else
              np.asarray(v) for v in obj.values()]
    return load_raw_from_values(graph, values)


def params_to_torch(params: Dict,
                    device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{key: {'w': f32[O,I,kh,kw], 'b': f32[O]}, 'dfl': {'w': ...}} of
    numpy arrays (or tensors) -> the same structure of float32 tensors on
    device."""
    return {key: {name: torch.as_tensor(v, dtype=torch.float32,
                                        device=device)
                  for name, v in p.items()}
            for key, p in params.items()}
