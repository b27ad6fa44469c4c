"""Parameter checkpoint IO (counterpart of
alpha_yolo_quant_tpu/utils/params_io.py, numpy logic unchanged).

Native format: a flat .npz ('<key>.w' / '<key>.b' arrays), deterministic
and readable by both packages. Torch-format checkpoints (the reference's
state dicts) load through models.params.load_torch_checkpoint. The JAX
package's orbax pair (save_params_orbax / load_params_orbax) has no
counterpart here: orbax is a JAX library.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def save_params(params: Dict, path: str) -> None:
    flat = {}
    for key, p in params.items():
        for f, v in p.items():
            flat[f"{key}.{f}"] = np.asarray(v)
    np.savez_compressed(path, **flat)


def load_params(path: str) -> Dict:
    out: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(path) as z:
        for name in z.files:
            key, f = name.rsplit(".", 1)
            out.setdefault(key, {})[f] = z[name]
    return out
