"""Evaluation: COCO-val mAP harness, detection/annotation metric rows,
run-result plots."""
