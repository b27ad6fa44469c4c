"""Gzip-pickle weight artifacts + packed state-dict reassembly.

Format contract (reference utils/save_weights.py:9-33): per layer
``weights_pickle/{layer}_conv.pickle`` / ``{layer}_bias.pickle`` and
``bias_scales/{layer}_scale.pickle`` — pickle protocol 4 inside gzip
compresslevel 3. We pin the gzip mtime to 0 so artifacts are byte-stable
across runs (the reference embeds wall-clock mtimes; payload bytes are
identical).

The packed state dict (stage-7 analog, reference stage_7.py:755-780)
replaces the reference's file-MTIME-ordering hack — stage_6 literally
sleeps 1.5s between writes so stage_7 can sort pickles by modification
time — with an explicit name map derived from the graph, which serializes
in the same order by construction.

Counterpart of alpha_yolo_quant_tpu/export/pickles.py, numpy logic unchanged;
both packages write the same bytes and read each other's files.
"""

from __future__ import annotations

import gzip
import io
import os
import pickle
from collections import OrderedDict
from typing import Dict

import numpy as np
import torch

from alpha_yolo_quant_torch.quantize.transform import QuantizedModel


def dump_gz_pickle(obj, path: str) -> None:
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb", compresslevel=3, mtime=0) as g:
        pickle.dump(obj, g, protocol=4)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


def load_gz_pickle(path: str):
    with gzip.open(path, "rb") as g:
        return pickle.load(g)


def save_layer_pickles(model: QuantizedModel, out_dir: str) -> None:
    """Per-layer conv/bias/scale pickles for every quantized conv
    (int64 arrays, like the reference's)."""
    wp = os.path.join(out_dir, "weights_pickle")
    bs = os.path.join(out_dir, "bias_scales")
    os.makedirs(wp, exist_ok=True)
    os.makedirs(bs, exist_ok=True)
    for name, c in model.convs.items():
        dump_gz_pickle(np.int64(c.w_q), os.path.join(wp, f"{name}_conv.pickle"))
        # bias layout (1,C,1,1): reference transposes to that shape before
        # saving (stage_6.py:100-108 works on (1,C,1,1) biases)
        dump_gz_pickle(np.int64(c.b_q).reshape(1, -1, 1, 1),
                       os.path.join(wp, f"{name}_bias.pickle"))
        dump_gz_pickle(np.asarray(c.acc_scale, np.float64),
                       os.path.join(bs, f"{name}_scale.pickle"))
    if model.head is not None:
        dump_gz_pickle(np.int64(model.head.dfl_w_q),
                       os.path.join(wp, "dfl_conv.pickle"))
        dump_gz_pickle(np.zeros(model.head.dfl_w_q.shape, np.int64),
                       os.path.join(wp, "dfl_bias.pickle"))


def load_scales(out_dir: str) -> Dict[str, np.ndarray]:
    """Read back all bias_scales (reference utils/save_weights.py:36-42)."""
    d = os.path.join(out_dir, "bias_scales")
    out = {}
    for fn in os.listdir(d):
        out[fn.split("_scale")[0]] = load_gz_pickle(os.path.join(d, fn))
    return out


def packed_state_dict(model: QuantizedModel, params: Dict) -> OrderedDict:
    """The QUANT_WEIGHTS_{K} state dict: every conv's int weights/biases as
    float32 arrays under the reference's state-dict keys (reference
    stage_7.py:755-780 loads mtime-sorted weights_pickle files into the
    nn.Module state dict).

    dfl.weight follows what stage_7 actually packs: on a PARTIAL tree the
    mtime-last pickle is the float dfl (stage_6.py:618 dfl.pickle), on a
    FULL-quant tree it is the QUANTIZED dfl_conv.pickle
    (stage_6_full_quant.py:755 + utils/save_weights.py write order), so
    the 8b deployed runtime runs the packed ints with the scale read from
    bias_scales/dfl_scale.pickle (stage_8_torch_full_quant.py:1232-1233).
    The JAX package's copy is byte-gated against a real stage_7
    execution."""
    sd: "OrderedDict[str, np.ndarray]" = OrderedDict()
    for node in model.graph.convs():
        c = model.convs[node.name]
        sd[f"{node.key}.weight"] = np.float32(c.w_q)
        sd[f"{node.key}.bias"] = np.float32(c.b_q)
    if model.cfg.full_quant and model.head is not None:
        sd["dfl.weight"] = np.float32(model.head.dfl_w_q).reshape(
            1, 16, 1, 1)
    else:
        sd["dfl.weight"] = np.asarray(params["dfl"]["w"], np.float32)
    return sd


def save_packed_state_dict(model: QuantizedModel, params: Dict,
                           path: str) -> None:
    """Serialize with torch.save, like the reference artifact."""
    sd = packed_state_dict(model, params)
    torch.save(OrderedDict((k, torch.from_numpy(np.ascontiguousarray(v)))
                           for k, v in sd.items()), path)


def load_packed_state_dict(path: str) -> OrderedDict:
    """Load a torch.save state dict, or the gz-pickle of numpy arrays the
    JAX package writes where torch is absent (told apart by the gzip
    magic bytes)."""
    with open(path, "rb") as f:
        gz = f.read(2) == b"\x1f\x8b"
    if gz:
        return load_gz_pickle(path)
    obj = torch.load(path, map_location="cpu", weights_only=True)
    return OrderedDict((k, v.numpy()) for k, v in obj.items())
