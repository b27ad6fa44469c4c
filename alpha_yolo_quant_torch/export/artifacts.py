"""Full artifact export: walks the graph + a golden-image run and emits the
reference's complete per-layer artifact tree (stage-6 analog).

Directory layout (reference utils/create_dirs.py:4-14):
  {out}/quant_weights_yolov8n/  per-layer weight+bias Verilog txt
  {out}/quant_activations/{conv2d,silu}/  golden activation vectors +
      rescale/shift appends
  {out}/weights_pickle/, {out}/bias_scales/  gzip pickles
  {out}/first_pixel/  naive-conv bring-up traces
  {out}/results/  packed state dict, calibration files

Export naming quirks reproduced deliberately: the neck C2F_12 concat
requant is labeled '_REQUANT' while C2F_15/18/21 use '_RESCALE'
(reference stage_6.py); backbone residuals write '_RESCALE' + '_SUMM'.

Counterpart of alpha_yolo_quant_tpu/export/artifacts.py, numpy logic unchanged;
both packages write the same bytes and read each other's files.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from alpha_yolo_quant_torch.export import verilog
from alpha_yolo_quant_torch.export.pickles import (
    dump_gz_pickle, save_layer_pickles, save_packed_state_dict,
)
from alpha_yolo_quant_torch.models.graph import (
    ConcatNode, ConvNode, MaxPoolNode, ResidualAddNode,
    require_contract_levels, require_dense_graph,
)
from alpha_yolo_quant_torch.quantize.transform import QuantizedModel


def make_dirs(out: str) -> None:
    for p in ("", "batches", "bias_scales", "results", "results/runs_val",
              "first_pixel", "quant_weights_yolov8n", "quant_activations",
              "quant_activations/conv2d", "quant_activations/silu",
              "weights_pickle"):
        os.makedirs(os.path.join(out, p), exist_ok=True)


def _first_pixel_trace(path: str, x: np.ndarray, w: np.ndarray,
                       b: np.ndarray, padding: int) -> np.int64:
    """Naive recomputation of output pixel (0,0,0,0) with its inputs
    (reference utils/conv2d_print_fp.py:15-48).

    Dtype quirk reproduced for byte parity: the reference pads into a
    default-FLOAT64 np.zeros (conv2d_print_fp.py:6), so padded (3x3)
    layers print the IMG patch and CUR RESULT as floats, while unpadded
    (1x1) layers use the int array directly and print ints; FIRST_PIXEL
    accumulates in float64 either way."""
    if padding:
        xp = np.zeros((x.shape[0], x.shape[1], x.shape[2] + 2 * padding,
                       x.shape[3] + 2 * padding))          # float64
        xp[:, :, padding:padding + x.shape[2],
           padding:padding + x.shape[3]] += x
    else:
        xp = np.int64(x)
    kh, kw = w.shape[2], w.shape[3]
    total = np.float64(0)
    with open(path, "w") as f:
        for c in range(x.shape[1]):
            layer = xp[0, c, :kh, :kw]
            weight = np.int64(w[0, c])
            part = np.sum(np.multiply(layer, weight))
            total += part
            f.write(f"IMG {c}:\n{layer}\n")
            f.write(f"CONV {c}:\n{weight}\n")
            f.write(f"CUR RESULT_{c}: {part}\n\n")
        total = total + np.float64(b[0])
        f.write(f"\nFIRST_PIXEL: {total}, BIAS: {b[0]}\n\n")
    return np.int64(total)


def _fp_append_rescale(path: str, value: np.ndarray, rescale, shift,
                       per_channel: bool) -> None:
    """RESULT AFTER RESCALE line (reference utils/conv2d_print_fp.py:56-63;
    note its hard-coded +-127 clip)."""
    r = np.asarray(rescale).reshape(1, -1, 1, 1)
    s = np.asarray(shift).reshape(1, -1, 1, 1)
    v = np.int64(value)
    q = (np.int64(r[0, 0, 0, 0]) * v) >> max(int(s[0, 0, 0, 0]) - 1, 0)
    q = q // 2 + q % 2
    q = int(np.clip(q, -127, 127))
    with open(path, "a") as f:
        f.write(f"\nRESULT AFTER RESCALE: {q}, "
                f"RESCALE_COEFF: {r[0, 0, 0, 0]}, SHIFT: {s[0, 0, 0, 0]}\n")


def _fp_append_silu(path: str, value) -> None:
    with open(path, "a") as f:
        f.write(f"\nSILU: {value}\n")


# concat-requant suffix quirks (see module docstring)
_REQUANT_SUFFIX = {"C2F_12_bottle_1": "REQUANT", "CONCAT_2X3": "REQUANT",
                   "CONCAT_1X3": "REQUANT", "CONCAT_3X4": "REQUANT",
                   "CONCAT_SPPFx3": "REQUANT"}


def export_all(model: QuantizedModel, env: Dict[str, np.ndarray],
               params: Dict, out_dir: str, warn=print) -> None:
    """Write every artifact for one golden-image run.

    env: the edge environment from runtime.golden.golden_forward (int64).
    Refuses a graph with other detect levels than the contract's (P6),
    and one with depthwise convs or attention (YOLO11).
    """
    require_contract_levels(model.graph, "export")
    require_dense_graph(model.graph, "export")
    make_dirs(out_dir)
    cfg = model.cfg
    k = cfg.k
    g = model.graph

    verilog.save_lut_table(
        model.sig_lut, "sigmoid",
        os.path.join(out_dir, f"sigmoid_table_{k}_bit.txt"))
    if model.head is not None:
        verilog.save_lut_table(
            model.head.exp_lut, "exponent",
            os.path.join(out_dir,
                         f"exponent_table_{model.head.exp_lut.bits}_bit.txt"))
        verilog.save_lut_table(
            model.head.cls_sigmoid_lut, "sigmoid",
            os.path.join(out_dir,
                         f"sigmoid_table_{cfg.cls_sigmoid_bits}_bit.txt"))

    # start image (reference stage_6.py conv_quant start branch)
    verilog.save_txt_activations(np.int64(env[g.input_edge]), "start",
                                 out_dir, "start_img", k, warn=warn)

    # the calibration file travels with the artifacts (the stage-8 load
    # path needs it: reference stage_8_torch.py:263)
    from alpha_yolo_quant_torch.utils.io import write_max_a

    write_max_a(os.path.join(out_dir, "results", "max_a.txt"), model.max_a)

    save_layer_pickles(model, out_dir)
    save_packed_state_dict(
        model, params,
        os.path.join(out_dir, "results", f"QUANT_WEIGHTS_{k}.pickle"))
    if not cfg.full_quant:
        # dtype-native f32: the reference dumps weights_activ's float32
        # 'dfl.weight' array as-is (stage_6.py:618 save_in_file)
        dump_gz_pickle(np.asarray(params["dfl"]["w"], np.float32),
                       os.path.join(out_dir, "weights_pickle", "dfl.pickle"))
    # re-exporting one head mode over a tree that held the other must not
    # leave the other mode's dfl artifacts behind: loadq's full-vs-partial
    # detection keys on exactly these files, and a stale dfl_scale.pickle
    # under a fresh partial packing would build a silently wrong head plan
    for rel in (("weights_pickle/dfl_conv.pickle",
                 "weights_pickle/dfl_bias.pickle",
                 "bias_scales/dfl_scale.pickle") if not cfg.full_quant
                else ("weights_pickle/dfl.pickle",)):
        p = os.path.join(out_dir, rel)
        if os.path.exists(p):
            os.remove(p)

    for idx, node in enumerate(g.nodes):
        if isinstance(node, ConvNode):
            c = model.convs[node.name]
            bias_4d = np.int64(c.b_q).reshape(1, -1, 1, 1)
            verilog.save_txt_weight(np.int64(c.w_q), bias_4d, node.name,
                                    "Conv2D", k, out_dir, warn=warn)
            fp_path = os.path.join(out_dir, "first_pixel",
                                   f"{node.name}_fp.txt")
            _first_pixel_trace(fp_path, np.int64(env[node.src]), c.w_q,
                               c.b_q, node.padding)
            if node.silu:
                dom = env[f"{node.name}:sigdom"]
                verilog.save_txt_activations(dom, node.name, out_dir,
                                             "act_conv", k, warn=warn)
                verilog.save_txt_rescale_shift(dom, c.r1, c.s1, node.name,
                                               out_dir, "act_conv", k,
                                               warn=warn)
                out = env[node.dst]
                verilog.save_txt_activations(out, node.name, out_dir,
                                             "act_silu", k, silu=True,
                                             warn=warn)
                verilog.save_txt_rescale_shift(out, c.r2, c.s2, node.name,
                                               out_dir, "act_silu", k,
                                               silu=True, warn=warn)
                # first-pixel: requant1 on the raw accumulator, then the
                # sigma*acc product, then requant2 applied per reference
                sig = model.sig_lut
                acc0 = _recompute_acc0(env[node.src], c, node)
                _fp_append_rescale(fp_path, acc0, c.r1, c.s1, True)
                dom0 = int(np.asarray(dom)[0, 0, 0, 0])
                sigma0 = int(sig.apply_np(np.array(dom0)))
                _fp_append_silu(fp_path, np.int64(sigma0) * acc0)
                out0 = int(np.asarray(out)[0, 0, 0, 0])
                _fp_append_rescale(fp_path, out0, c.r2, c.s2, True)
        elif isinstance(node, ResidualAddNode):
            req = env[f"{node.label}:rescale"]
            rq = model.requants[(idx, node.src)]
            verilog.save_txt_activations(req, f"{node.label}_RESCALE",
                                         out_dir, "act_silu", k, silu=True,
                                         warn=warn)
            verilog.save_txt_rescale_shift(req, rq.rescale, rq.shift,
                                           f"{node.label}_RESCALE", out_dir,
                                           "act_silu", k, silu=True,
                                           warn=warn)
            verilog.save_txt_activations(env[node.dst], f"{node.label}_SUMM",
                                         out_dir, "act_silu", k, silu=True,
                                         warn=warn)
        elif isinstance(node, ConcatNode):
            suffix = _REQUANT_SUFFIX.get(node.label, "RESCALE")
            for e in node.srcs:
                if (idx, e) in model.requants:
                    rq = model.requants[(idx, e)]
                    req = env[f"{node.label}:{e}:requant"]
                    verilog.save_txt_activations(
                        req, f"{node.label}_{suffix}", out_dir, "act_silu",
                        k, silu=True, warn=warn)
                    verilog.save_txt_rescale_shift(
                        req, rq.rescale, rq.shift, f"{node.label}_{suffix}",
                        out_dir, "act_silu", k, silu=True, warn=warn)
            if node.label != "SPPF_POOLCAT":
                verilog.save_txt_activations(
                    env[node.dst], f"{node.label}_CONCAT", out_dir,
                    "act_silu", k, silu=True, warn=warn)
        elif isinstance(node, MaxPoolNode):
            verilog.save_txt_activations(env[node.dst], node.label, out_dir,
                                         "act_silu", k, silu=True, warn=warn)

    if cfg.full_quant and model.head is not None:
        _export_full_quant_head(model, env, out_dir, warn)


def _export_full_quant_head(model: QuantizedModel, env: Dict,
                            out_dir: str, warn) -> None:
    """The 6b-only head artifacts (reference stage_6_full_quant.py:
    596-761): per-level box requants to the fixed DFL scale
    ('{up}_REQUANT', 8-bit, silu dir), 16-bit cls requants to scale(12,16)
    (conv2d dir), and the quantized-DFL conv set — weight txt with a fake
    zero bias, first-pixel trace over the softmax ints, its scale pickle,
    and the 16-bit anchor-scale requant dump."""
    import os

    from alpha_yolo_quant_torch.export.pickles import dump_gz_pickle
    from alpha_yolo_quant_torch.runtime.golden import head_intermediates_np

    h = model.head
    k = model.cfg.k
    it = head_intermediates_np(model, env)
    for level in model.graph.levels:
        d = it["levels"][level]
        up_name = model.graph.head_conv(f"{level}_box")
        dn_name = model.graph.head_conv(f"{level}_cls")
        # the box requant is PINNED to 8-bit regardless of the backbone
        # K — the reference hard-codes requant_last_layers(..., 8)
        # (stage_6_full_quant.py:603-608, writer at :229-233), so at
        # K=6 the files are still named/formatted bit_8 (the K=6 tree
        # gate caught the k-following version of this call)
        verilog.save_txt_activations(d["bq"], f"{up_name}_REQUANT",
                                     out_dir, "act_conv", 8, silu=True,
                                     warn=warn)
        verilog.save_txt_rescale_shift(d["bq"], d["b_r"], d["b_s"],
                                       f"{up_name}_REQUANT", out_dir,
                                       "act_conv", 8, silu=True, warn=warn)
        verilog.save_txt_activations(d["cq"], dn_name, out_dir, "act_conv",
                                     16, warn=warn)
        verilog.save_txt_rescale_shift(d["cq"], d["c_r"], d["c_s"],
                                       dn_name, out_dir, "act_conv", 16,
                                       warn=warn)

    dfl_w4 = np.int64(h.dfl_w_q).reshape(1, 16, 1, 1)
    fake_bias = np.zeros((1, 16, 1, 1), np.int64)
    verilog.save_txt_weight(dfl_w4, fake_bias, "dfl", "Conv2D", k,
                            out_dir, warn=warn)
    _first_pixel_trace(os.path.join(out_dir, "first_pixel", "dfl_fp.txt"),
                       it["p"], dfl_w4, np.zeros(16, np.int64), 0)
    dump_gz_pickle(
        np.float64(h.dfl_acc_scale).reshape(1, 1, 1, 1),
        os.path.join(out_dir, "bias_scales", "dfl_scale.pickle"))
    verilog.save_txt_activations(it["dfl_q4"], "dfl", out_dir, "act_conv",
                                 16, warn=warn)
    verilog.save_txt_rescale_shift(it["dfl_q4"], it["dfl_r"], it["dfl_s"],
                                   "dfl", out_dir, "act_conv", 16,
                                   warn=warn)


def _recompute_acc0(x_int: np.ndarray, plan, node: ConvNode) -> np.int64:
    """Accumulator value at output pixel (0,0,0,0) (for the fp trace)."""
    p = node.padding
    x = np.int64(x_int)
    if p:
        xp = np.zeros((x.shape[0], x.shape[1], x.shape[2] + 2 * p,
                       x.shape[3] + 2 * p), np.int64)
        xp[:, :, p:p + x.shape[2], p:p + x.shape[3]] = x
    else:
        xp = x
    kh, kw = plan.w_q.shape[2], plan.w_q.shape[3]
    patch = xp[0, :, :kh, :kw]
    return np.sum(patch * np.int64(plan.w_q[0])) + np.int64(plan.b_q[0])
