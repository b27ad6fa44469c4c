"""MACs and bytes of the convs, counted from graph shapes and edge dtypes,
against the program's own counts."""

import pytest
import torch

from benchmark import counts, inputs, run, spec

REF = spec.reference({})


@pytest.mark.parametrize("model,macs", [("yolov8n", 4_371_456_000),
                                        ("yolov8m", 39_467_827_200)])
def test_image_macs(model, macs):
    from alpha_yolo_quant_torch.config import QuantConfig
    from alpha_yolo_quant_torch.models.graph import (
        build_yolov8_graph, node_costs,
    )

    g = REF.graph.build_yolov8_graph(REF.config.QuantConfig(model=model))
    assert counts.image_macs(g, REF.graph.edge_shapes(g, 640)) == macs
    pg = build_yolov8_graph(QuantConfig(model=model))
    assert sum(node_costs(pg, 640)) == macs


def test_bytes_agree_with_the_program_plan(one_thread):
    """At 640 and B=128, each conv's bytes equal those engine_profile's
    bound reads off the kernel's arguments (input, output, packed
    weights, constants), wherever the packed weights carry no padding
    (depth k*k*Cin a multiple of 64); edge dtypes agree everywhere."""
    from alpha_yolo_quant_torch.engine_profile import nbytes
    from alpha_yolo_quant_torch.models.graph import build_yolov8_graph
    from alpha_yolo_quant_torch.quantize.transform import (
        build_quantized_model,
    )
    from alpha_yolo_quant_torch.runtime import fused_ops
    from alpha_yolo_quant_torch.runtime.interpreter import _store_dtype

    config = {"model": "yolov8n", "k": 8, "full_quant": True,
              "image_size": 640, "koeff_bits": 8}
    cfg = run.ref_cfg(config)
    graph = REF.graph.build_yolov8_graph(cfg)
    seeds = inputs.Seeds(9)
    params = inputs.make_params(graph, seeds, "cpu")
    max_a = inputs.make_max_a(REF, graph, params, seeds, 1, 640, "cpu")
    qm = REF.quant.quantize_model(graph, params, max_a, cfg)
    pcfg = __import__("alpha_yolo_quant_torch.config",
                      fromlist=["QuantConfig"]).QuantConfig(
        model="yolov8n", k=8, full_quant=True, image_size=640)
    pm = build_quantized_model(build_yolov8_graph(pcfg), params, max_a, pcfg)
    assert {e: v > 127 for e, v in qm.edge_amax.items()} == \
        {e: v > 127 for e, v in pm.edge_amax_int.items()}
    shapes = REF.graph.edge_shapes(graph, 640)
    mine = counts.conv_bytes(graph, shapes, qm.edge_amax, 128)
    checked = 0
    for node in graph.convs():
        if (node.kernel ** 2 * node.cin) % fused_ops.K_TILE:
            continue
        c = pm.convs[node.name]
        e = fused_ops.conv_entry(c.w_q, c.b_q, node.stride, node.padding,
                                 node.silu, "cpu", r1=c.r1, s1=c.s1,
                                 r2=c.r2, s2=c.s2)
        x = torch.empty((128,) + shapes[node.src][1:] + shapes[node.src][:1],
                        dtype=_store_dtype(pm, node.src))
        out = torch.empty((128,) + shapes[node.dst][1:] + shapes[node.dst][:1],
                          dtype=torch.int8 if node.silu else torch.int32)
        consts = [e[f] for f in ("b", "r1", "s1", "r2", "s2") if f in e]
        assert mine[node.name] == nbytes(x, out, e["w_packed"], *consts)
        checked += 1
    assert checked >= 40
    wide = [n for n in graph.convs() if qm.edge_amax[n.src] > 127]
    assert wide
