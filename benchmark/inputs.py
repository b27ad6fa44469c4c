"""Everything a run consumes, made from ``--seed``: the fused float weights,
the calibration (``max_a``), the image pool and the sample of it that is
checked.

Each use draws from its own stream of one ``numpy.random.SeedSequence``,
so the same seed gives the same inputs and changing one use (the length
of the window, say) changes no other. Weights, calibration images and
pools are drawn on the device by ``torch.Generator`` in one call each and
brought to the host once, where the program takes them: the numpy
weights that its quantizer reads, the uint8 images that users hand it.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

STREAMS = ("weights", "calibration", "pool", "sample")


class Seeds:
    """Independent streams of one seed, by use."""

    def __init__(self, seed: int):
        children = np.random.SeedSequence(abs(int(seed))).spawn(len(STREAMS))
        self._ss = dict(zip(STREAMS, children))

    def numpy(self, use: str) -> np.random.Generator:
        return np.random.default_rng(self._ss[use])

    def torch(self, use: str, device) -> torch.Generator:
        g = torch.Generator(device=device)
        g.manual_seed(int(self._ss[use].generate_state(1, np.uint64)[0]
                          >> np.uint64(1)))
        return g


def make_params(graph, seeds: Seeds, device) -> Dict:
    """Fused float32 params of every conv: weights normal with variance
    1/fan_in (variance-conserving, so that sixty stacked SiLU convs stay
    calibratable), biases normal with sd 0.02, the DFL weight arange(16);
    one draw for all weights and one for all biases."""
    convs = graph.convs()
    sizes = [n.cout * n.cin * n.kernel ** 2 for n in convs]
    fan = torch.tensor([n.cin * n.kernel ** 2 for n in convs],
                       dtype=torch.float32, device=device)
    g = seeds.torch("weights", device)
    sd = torch.repeat_interleave(fan.rsqrt(), torch.tensor(sizes,
                                                           device=device))
    w = (torch.randn(sum(sizes), generator=g, device=device) * sd).cpu()
    b = (torch.randn(sum(n.cout for n in convs), generator=g, device=device)
         * 0.02).cpu()
    w, b = w.numpy(), b.numpy()
    params: Dict[str, Dict[str, np.ndarray]] = {}
    wo = bo = 0
    for n, size in zip(convs, sizes):
        params[n.key] = {
            "w": w[wo:wo + size].reshape(n.cout, n.cin, n.kernel, n.kernel),
            "b": b[bo:bo + n.cout]}
        wo += size
        bo += n.cout
    params["dfl"] = {"w": np.arange(16, dtype=np.float32).reshape(1, 16, 1,
                                                                   1)}
    return params


def make_max_a(ref, graph, params: Dict, seeds: Seeds, n_images: int,
               image_size: int, device) -> Dict[str, float]:
    """The calibration a deployment's ``calibrate`` step writes: per tap the
    largest pre-activation magnitude of the plain float forward of the
    cell's reference ``ref`` (benchmark/spec.reference) over ``n_images``
    seeded images, uniform in [0, 1)."""
    x = torch.rand((n_images, 3, image_size, image_size),
                   generator=seeds.torch("calibration", device),
                   device=device)
    return ref.forward.calibration_taps(graph, params, x)


def make_pool(seeds: Seeds, n_images: int, image_size: int,
              device) -> np.ndarray:
    """``n_images`` distinct uint8 host images (NCHW)."""
    t = torch.randint(0, 256, (n_images, 3, image_size, image_size),
                      generator=seeds.torch("pool", device), device=device,
                      dtype=torch.uint8)
    return t.cpu().numpy()
