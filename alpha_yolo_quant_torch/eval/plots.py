"""Plotting: detection overlay, per-run mAP curves, LUT visualization
(reference utils/coco.py:105-149, utils/plot_run_results.py:29-61,
utils/sigmoid_visual.py:1-25). Headless-safe (Agg).

Counterpart of alpha_yolo_quant_tpu/eval/plots.py, with the per-layer
SRAM heatmaps of hwsim.sram; matplotlib is imported only when a plot is
drawn.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_detections(image_chw: np.ndarray, boxes_xyxy: np.ndarray,
                    labels: Sequence[str], scores: Sequence[float],
                    path: str) -> None:
    """Overlay detections on an image (plot_res analog)."""
    plt = _plt()
    import matplotlib.patches as patches

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.imshow(np.clip(image_chw.transpose(1, 2, 0), 0, 1))
    for box, lab, sc in zip(boxes_xyxy, labels, scores):
        x1, y1, x2, y2 = box
        ax.add_patch(patches.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                       linewidth=1.5, edgecolor="lime",
                                       facecolor="none"))
        ax.text(x1, y1 - 2, f"{lab} {sc:.2f}", color="lime", fontsize=8)
    ax.axis("off")
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)


def plot_run_results(out_dir: str, path: Optional[str] = None) -> str:
    """Per-run mAP curve from results.txt (plot_run_results analog)."""
    from alpha_yolo_quant_torch.utils.run_log import read_run_results

    plt = _plt()
    runs = read_run_results(out_dir)
    path = path or os.path.join(out_dir, "results", "runs_val", "runs.png")
    fig, ax = plt.subplots(figsize=(8, 4))
    ax.plot([r["map"] for r in runs], marker="o")
    ax.set_xlabel("run")
    ax.set_ylabel("mAP 50-95")
    ax.grid(True, alpha=0.3)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return path


def plot_memory_heatmaps(sim, out_dir: str, grid_width: int = 512,
                         limit: Optional[int] = None) -> int:
    """Per-layer SRAM occupancy heatmaps (reference utils/mem_ckecker.py:
    167-174 plot_memory: one seaborn heatmap per traced op into memory/,
    titled 'MEM: <occupied> | READ: <r> | WRITE: <w>', file named by the
    write tensor). Row occupancy is reshaped into a (H, grid_width) raster.
    Returns the number of images written."""
    plt = _plt()
    mem_dir = os.path.join(out_dir, "memory")
    os.makedirs(mem_dir, exist_ok=True)
    total_rows = sim.total_rows
    height = -(-total_rows // grid_width)
    n = 0
    snaps = sim.snapshots if limit is None else sim.snapshots[:limit]
    for read_name, write_name, segs in snaps:
        occ = np.zeros(height * grid_width, np.float32)
        used = 0
        for start, rows in segs:
            occ[start:start + rows] = 1.0
            used += rows
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.imshow(occ.reshape(height, grid_width), aspect="auto",
                  interpolation="nearest", cmap="viridis", vmin=0, vmax=1)
        ax.set_title(f"MEM: {used * sim.columns} | READ: {read_name} | "
                     f"WRITE: {write_name}", fontsize=8)
        ax.set_xlabel("row % grid")
        ax.set_ylabel("row // grid")
        safe = "".join(c if c.isalnum() or c in "._-" else "_"
                       for c in write_name)
        fig.savefig(os.path.join(mem_dir, f"{safe}.png"),
                    bbox_inches="tight", dpi=90)
        plt.close(fig)
        n += 1
    return n


def plot_lut(lut, path: str) -> str:
    """LUT curve (sigmoid_visual analog)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.plot(np.arange(lut.lo, lut.hi + 1), lut.values)
    ax.set_xlabel("quantized input")
    ax.set_ylabel("quantized output")
    ax.grid(True, alpha=0.3)
    fig.savefig(path, bbox_inches="tight", dpi=120)
    plt.close(fig)
    return path
