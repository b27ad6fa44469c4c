"""The PyTorch port's Hopper kernels on a CUDA card: each kernel against its
plain version, and the 64-px pipeline on the card against the CPU run and
the numpy int64 oracle. Bit-exact.

These tests need a card and nvcc and skip without them. They import no
JAX, so they also run where JAX is not installed, without the repo's
conftest.py (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from alpha_yolo_quant_tpu.config import QuantConfig
from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph
from alpha_yolo_quant_tpu.models.params import init_params
from alpha_yolo_quant_tpu.quantize.luts import sigmoid_lut
from alpha_yolo_quant_tpu.runtime.golden import golden_forward
from alpha_yolo_quant_torch.ops.lut import DeviceLut
from alpha_yolo_quant_torch.quantize.calibrate import (
    collect_stats, reduce_stats,
)
from alpha_yolo_quant_torch.quantize.transform import build_quantized_model
from alpha_yolo_quant_torch.runtime import fused_ops
from alpha_yolo_quant_torch.runtime.interpreter import (
    build_int_pipeline, device_plan, int_forward, quantize_input,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the Hopper kernels have no CPU mode)")
    return torch.device("cuda")


# (cin, cout, kernel, stride, hw, wide input, silu): ragged rows and
# columns, the Cin = 3 and Cin % 4 != 0 gathered loads, int16 inputs
CASES = [(3, 16, 3, 2, 33, False, True), (16, 16, 3, 1, 20, False, True),
         (32, 64, 3, 2, 41, False, True), (48, 32, 1, 1, 13, False, True),
         (64, 64, 1, 1, 10, False, False), (80, 80, 1, 1, 10, False, False),
         (32, 32, 3, 1, 9, True, True), (128, 64, 1, 1, 7, True, True),
         (6, 20, 3, 1, 5, True, False), (256, 72, 3, 1, 6, False, True)]


@pytest.mark.parametrize("case", CASES, ids=[
    f"{c[0]}-{c[1]}-k{c[2]}s{c[3]}-{c[4]}px{'-wide' if c[5] else ''}"
    f"{'' if c[6] else '-plain'}" for c in CASES])
def test_conv_kernel_equals_plain(cuda, case):
    cin, cout, k, stride, hw, wide, silu = case
    rng = np.random.default_rng(hash(case) % 2 ** 32)
    amax = 381 if wide else 127
    x = torch.as_tensor(rng.integers(-amax, amax + 1, (3, hw, hw, cin)),
                        dtype=torch.int16 if wide else torch.int8,
                        device=cuda)
    w = rng.integers(-127, 128, (cout, cin, k, k))
    b = rng.integers(-2 ** 15, 2 ** 15, cout)
    r1, r2 = rng.integers(1, 256, cout), rng.integers(1, 256, cout)
    s1, s2 = rng.integers(1, 24, cout), rng.integers(8, 32, cout)
    c = fused_ops.conv_entry(w, b, stride, k // 2, silu, cuda, r1=r1, s1=s1,
                             r2=r2, s2=s2)
    sig = DeviceLut(sigmoid_lut(6.0, 8), cuda)
    wrapper = fused_ops.conv1x1 if k == 1 else fused_ops.conv3x3
    before = fused_ops.LAUNCHES[wrapper.__name__]
    got = wrapper(x, c, sig, 127)
    want = fused_ops.conv_plain(x, c, sig, 127)
    torch.cuda.synchronize()
    assert fused_ops.LAUNCHES[wrapper.__name__] == before + 1
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


def test_sigma_probe_returns_the_table(cuda):
    sig = DeviceLut(sigmoid_lut(6.0, 8), cuda)
    assert torch.equal(fused_ops.sigma_probe(sig).cpu(),
                       torch.as_tensor(sig.lut.values))
    assert fused_ops.sigma_corrections(sig) == ()


def test_pipeline_on_card_equals_cpu_and_golden(cuda):
    cfg = QuantConfig(model="yolov8n", k=8, full_quant=True, image_size=64)
    graph = build_yolov8_graph(cfg)
    params = init_params(graph, seed=0)
    rng = np.random.default_rng(0)
    calib = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    model = build_quantized_model(
        graph, params, reduce_stats(collect_stats(graph, params, [calib])),
        cfg)
    x = rng.uniform(0, 1, (4, 3, 64, 64)).astype(np.float32)
    fused_ops.reset_counts()
    det, n = build_int_pipeline(model, cuda)[0](torch.as_tensor(x,
                                                               device=cuda))
    assert fused_ops.LAUNCHES["conv1x1"] + fused_ops.LAUNCHES["conv3x3"] \
        == len(graph.convs())
    det_c, n_c = build_int_pipeline(model, "cpu")[0](x)
    assert torch.equal(det.cpu(), det_c) and torch.equal(n.cpu(), n_c)
    plan = device_plan(model, cuda)
    outs = int_forward(model, plan, quantize_input(
        torch.as_tensor(x[:1], device=cuda), 8))
    env = golden_forward(model, x[:1])
    for role in graph.outputs:
        np.testing.assert_array_equal(
            outs[role].cpu().numpy().astype(np.int64), env[role])
