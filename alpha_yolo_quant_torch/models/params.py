"""Float parameters onto a torch device: the float side of carrying
weights across from the JAX package (whose models/params.py builds the
numpy dict, e.g. ``init_params(graph, seed=0)``)."""

from __future__ import annotations

from typing import Dict

import torch


def params_to_torch(params: Dict,
                    device) -> Dict[str, Dict[str, torch.Tensor]]:
    """{key: {'w': f32[O,I,kh,kw], 'b': f32[O]}, 'dfl': {'w': ...}} of
    numpy arrays (or tensors) -> the same structure of float32 tensors on
    device."""
    return {key: {name: torch.as_tensor(v, dtype=torch.float32,
                                        device=device)
                  for name, v in p.items()}
            for key, p in params.items()}
