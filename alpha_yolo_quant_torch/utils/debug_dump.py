"""Raw-matrix debug dumps (reference utils/result_txt.py:1-19 and
utils/txt_matrix_print.py — the eyeball-diff artifacts of the bring-up
flow).

Counterpart of alpha_yolo_quant_tpu/utils/debug_dump.py, numpy logic unchanged;
both packages write the same bytes and read each other's files.
"""

from __future__ import annotations

import numpy as np


def result_txt(matrix: np.ndarray, path: str = "result_quant.txt",
               flat: bool = False) -> str:
    """Per-channel row dump of a (1,C,H,W) tensor, or a flat vector
    (reference utils/result_txt.py)."""
    m = np.asarray(matrix)
    with open(path, "w") as f:
        if flat or m.ndim == 1:
            f.write("".join(f"{v}  " for v in m.reshape(-1)) + "\n")
        else:
            for c in range(m.shape[1]):
                for row in m[0, c]:
                    f.write("".join(f"{v}  " for v in row) + "\n")
                f.write("\n")
    return path


def matrix_txt(matrix: np.ndarray, name: str, path: str) -> str:
    """Append a named matrix block (reference utils/txt_matrix_print.py)."""
    m = np.asarray(matrix)
    with open(path, "a") as f:
        f.write(f"{name}:\n{m}\n\n")
    return path


def dump_env(env, out_dir: str, names=None) -> None:
    """Write every edge of a runtime environment (int_forward keep_env /
    golden_forward) as .npy for offline diffing."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    for name, t in env.items():
        if names and name not in names:
            continue
        safe = name.replace("/", "_").replace(":", "_")
        np.save(os.path.join(out_dir, f"{safe}.npy"), np.asarray(t))
