"""The system under test, alpha_yolo_quant_torch, as a deployment runs it:
the quantizer builds the integer model from the fused float params and the
calibration, and ``build_int_pipeline`` serves it. The only module of the
benchmark that imports the program; the reference (benchmark/reference)
never does."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict

from benchmark.spec import ROOT

PROGRAM = "alpha_yolo_quant_torch"


def build(config: Dict, params: Dict, max_a: Dict[str, float], device):
    """The program's set-up: ``build_quantized_model`` at the configured
    bit widths, then ``build_int_pipeline`` on ``device`` with the
    configured engine and q_NMS parameters. Returns the pipeline's ``fn``:
    images (numpy, NCHW) -> (det (B, max_det, 6), n_det (B,)) on the
    device."""
    import alpha_yolo_quant_torch
    from alpha_yolo_quant_torch.config import QuantConfig
    from alpha_yolo_quant_torch.models.graph import build_yolov8_graph
    from alpha_yolo_quant_torch.postprocess.nms import q_nms_params
    from alpha_yolo_quant_torch.quantize.transform import (
        build_quantized_model,
    )
    from alpha_yolo_quant_torch.runtime.interpreter import build_int_pipeline

    if ROOT not in Path(alpha_yolo_quant_torch.__file__).resolve().parents:
        raise RuntimeError(f"{PROGRAM} is not the checkout's: "
                           f"{alpha_yolo_quant_torch.__file__}")
    if not config["full_quant"]:
        raise ValueError("the reference runs full quant with q_NMS only")
    cfg = QuantConfig(model=config["model"], k=config["k"],
                      full_quant=True, image_size=config["image_size"],
                      koeff_bits=config["koeff_bits"])
    model = build_quantized_model(build_yolov8_graph(cfg), params, max_a,
                                  cfg)
    nms = config["nms"]
    nms_params = dataclasses.replace(
        q_nms_params(model.head.anchor_scale, iou_thres=nms["iou_thres"],
                     conf_thres_int=nms["conf_thres_int"]),
        pre_topk=nms["pre_topk"], max_det=nms["max_det"],
        max_wh=nms["max_wh"])
    fn, _ = build_int_pipeline(model, device, nms_params=nms_params,
                               engine=config["engine"])
    return fn
