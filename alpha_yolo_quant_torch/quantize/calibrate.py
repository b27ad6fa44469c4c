"""Activation calibration: capture, activation dumps and statistics
reduction (counterpart of alpha_yolo_quant_tpu/quantize/calibrate.py,
whose module imports jax).

Reduction modes (reference utils/stage_5_common_func.py:11-26): max | mode
| median | std (mean + 3*sample-std) | n=<i> (i-th largest unique) |
min_mae (sigma-coefficient search, reference stage_5.py:34-89).
"""

from __future__ import annotations

import gzip
import os
import pickle
import re
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from alpha_yolo_quant_torch.models.graph import Graph
from alpha_yolo_quant_torch.models.forward import forward_float
from alpha_yolo_quant_torch.models.params import params_to_torch


@torch.no_grad()
def collect_stats(graph: Graph, params: Dict, batches: Iterable[np.ndarray],
                  device="cuda", dp: Optional[int] = None
                  ) -> Dict[str, List[float]]:
    """Run calibration batches on ``device`` (the card unless the caller
    names another); returns tap -> list of per-image maxima, taps in
    sorted order like the JAX function's (its tap dict comes back from the
    device with sorted keys), so both packages write the same max_a files.
    ``params``: the float params dict, numpy or torch.

    ``dp``: shard each batch over the first N ranks of the default process
    group (parallel.mesh). The group's first rank reads ``batches`` and
    sends each batch to the others (ignored there); each rank runs its
    rows, and the per-image maxima come back gathered in global row
    order, so every reduction mode sees the single-rank list. Every rank
    returns the records."""
    tp = params_to_torch(params, device)
    if dp:
        from alpha_yolo_quant_torch.parallel.mesh import (
            BatchFeed, gather_batch, make_mesh, shard_batch,
        )

        mesh = make_mesh(dp)
        batches = BatchFeed(mesh, device).share(batches)
    records: Dict[str, List[float]] = {}
    for batch in batches:
        if dp:
            batch = shard_batch(mesh, batch)
        elif not isinstance(batch, torch.Tensor):
            batch = np.asarray(batch)
        x = torch.as_tensor(batch, dtype=torch.float32, device=device)
        _, taps = forward_float(graph, tp, x, collect_taps=True)
        if dp:
            taps = gather_batch(mesh, taps)
        for name in sorted(taps):
            records.setdefault(name, []).extend(
                taps[name].cpu().numpy().tolist())
    return records


@torch.no_grad()
def collect_samples(graph: Graph, params: Dict,
                    batches: Iterable[np.ndarray], taps: List[str],
                    device="cuda") -> Dict[str, np.ndarray]:
    """Full pre-activation tensors (f32, NCHW, on the host) of the given
    taps over all batches, run on ``device``: the analog of the
    reference's gzip'd per-layer activation dumps used by the min_mae
    search (utils/save_weights.py:13-21)."""
    tp = params_to_torch(params, device)
    out: Dict[str, List[np.ndarray]] = {t: [] for t in taps}
    for batch in batches:
        x = torch.as_tensor(np.asarray(batch), dtype=torch.float32,
                            device=device)
        captured = dict.fromkeys(taps)
        forward_float(graph, tp, x, capture=captured)
        for t in taps:
            out[t].append(captured[t].cpu().numpy())
    return {t: np.concatenate(v, 0) for t, v in out.items()}


def save_batches(out_dir: str, samples: Dict[str, np.ndarray]) -> None:
    """Persist per-image activation dumps in the reference's artifact
    format: {out}/batches/{tap}/b_{i}.pickle, gzip compresslevel=3,
    pickle protocol 4 (reference utils/save_weights.py:13-21 save_batch).
    Each file holds one image's (1, C, H, W) pre-activation tensor."""
    for tap, arr in samples.items():
        d = os.path.join(out_dir, "batches", tap)
        os.makedirs(d, exist_ok=True)
        for i in range(arr.shape[0]):
            with gzip.open(os.path.join(d, f"b_{i}.pickle"), "wb",
                           compresslevel=3) as f:
                pickle.dump(arr[i:i + 1], f, protocol=4)


def load_batches(out_dir: str, taps: List[str]
                 ) -> Optional[Dict[str, np.ndarray]]:
    """Reload activation dumps for a resumable min_mae reduction (the
    reference re-reads them in stage 5: utils/stage_5_common_func.py:41-42
    load_from_file). Returns None if any tap's dump directory is missing
    or empty. The files are unpickled, so load only dumps this program
    wrote."""
    out: Dict[str, np.ndarray] = {}
    for tap in taps:
        d = os.path.join(out_dir, "batches", tap)
        if not os.path.isdir(d):
            return None
        files = sorted((f for f in os.listdir(d)
                        if re.fullmatch(r"b_\d+\.pickle", f)),
                       key=lambda f: int(f[2:-7]))
        if not files:
            return None
        parts = []
        for f in files:
            with gzip.open(os.path.join(d, f), "rb") as fh:
                parts.append(np.asarray(pickle.load(fh)))
        out[tap] = np.concatenate(parts, 0)
    return out


def _sample_std(v: np.ndarray) -> float:
    return float(np.std(v, ddof=1)) if len(v) > 1 else 0.0


# the stem's min_mae coefficient is fixed, not searched (reference
# utils/stage_5_common_func.py:81 writes 'conv_p1: 3')
DEFAULT_MIN_MAE_KOEF = {"conv_p1": 3.0}


def reduce_stats(records: Dict[str, List[float]], mode: str = "max",
                 k: int = 8,
                 samples: Optional[Dict[str, np.ndarray]] = None,
                 ) -> Dict[str, float]:
    """Reduce per-image statistics to one calibration value per tap
    (a copy of the JAX package's reduce_stats, which imports jax)."""
    out: Dict[str, float] = {"start": 1.0}
    mode_l = mode.lower()
    for name, values in records.items():
        if name.startswith("_") or name == "start":
            continue
        v = np.asarray(values, np.float64)
        if mode_l == "max":
            out[name] = float(np.abs(v).max())
        elif mode_l == "mode":
            # pandas value_counts semantics: among the top counts the
            # value seen first wins
            uniq, first, counts = np.unique(v, return_index=True,
                                            return_counts=True)
            top = counts == counts.max()
            out[name] = float(uniq[top][np.argmin(first[top])])
        elif mode_l == "median":
            out[name] = float(np.median(v))
        elif mode_l == "std":
            out[name] = float(v.mean() + 3 * _sample_std(v))
        elif mode_l.startswith("n="):
            n = int(mode_l[2:]) if mode_l[2:].isdigit() else 1
            uniq = np.unique(v)
            out[name] = float(uniq[max(-n - 1, -len(uniq))])
        elif mode_l == "min_mae":
            if samples is not None and name in samples:
                out[name] = min_mae_search(v, samples[name], k)[1]
            elif name in DEFAULT_MIN_MAE_KOEF:
                koef = DEFAULT_MIN_MAE_KOEF[name]
                out[name] = float(v.mean() + koef * _sample_std(v))
            else:
                raise ValueError(f"min_mae needs samples for {name}")
        else:
            raise ValueError(f"unknown calibration mode {mode}")
    return out


def min_mae_search(per_image_max: np.ndarray, acts: np.ndarray,
                   k: int) -> tuple:
    """Sweep a = mean + koef*std over koef in linspace(-2, 4, 50),
    minimizing |sum(x - dequant(quant(x, a)))| / N in float32; ties keep
    the later koef. Returns (best_koef, best_a)."""
    qmax = 2 ** (k - 1) - 1
    v = np.asarray(per_image_max, np.float64)
    mean, std = v.mean(), _sample_std(v)
    x = np.ascontiguousarray(acts, np.float32)
    best_koef, best_a, best_err = None, None, np.inf
    for koef in np.linspace(-2, 4, 50):
        a = mean + koef * std
        scale = qmax / a
        a32, s32 = np.float32(a), np.float32(scale)
        # sequential in-place clip: first v > a -> a, then v < -a -> -a
        m = np.where(x > a32, a32, x)
        m = np.where(m < -a32, -a32, m)
        q = np.rint(m * s32)
        deq = q.astype(np.int64).astype(np.float32) / s32
        err = float(np.abs(np.sum(x - deq) / np.float32(x.size)))
        if err <= best_err:
            best_err, best_koef, best_a = err, float(koef), float(a)
    return best_koef, best_a
