"""Host side of the conv kernels' tile choice (runtime/fused_ops.tile_n,
conv_loader), read from the port's own graph of each benchmark model at
its cell's image size and batch: every output tile is a legal
wgmma.m64nNk32 width, pads few columns, and the MACs the tensor cores
execute stay close to the useful ones."""

import numpy as np
import pytest
import torch

from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.models.graph import build_yolov8_graph, edge_shapes
from alpha_yolo_quant_torch.runtime import fused_ops

# (model, image size, batch) of the benchmark cells, and the largest
# executed / useful MAC ratio each may have
MODELS = [("yolov8n", 640, 128, 1.07), ("yolov8m", 640, 128, 1.03),
          ("yolov8m-p6", 1280, 32, 1.03)]
IDS = [m[0] for m in MODELS]
ROWS = 64      # conv_igemm.cuh BM: output rows a tile
STEP = 32      # depth of one wgmma k32 step


def _convs(model: str, size: int):
    graph = build_yolov8_graph(QuantConfig(model=model, image_size=size))
    return graph.convs(), edge_shapes(graph, size)


@pytest.mark.parametrize("model,size,batch,limit", MODELS, ids=IDS)
def test_every_cout_gets_a_wgmma_width(model, size, batch, limit):
    convs, _ = _convs(model, size)
    for n in convs:
        bn = fused_ops.tile_n(n.cout)
        assert bn % 16 == 0 and 16 <= bn <= fused_ops.MAX_TILE_N, n.name
        assert bn * -(-n.cout // bn) >= n.cout


@pytest.mark.parametrize("model,size,batch,limit", MODELS, ids=IDS)
def test_no_tile_pads_more_than_15_columns(model, size, batch, limit):
    convs, _ = _convs(model, size)
    for n in convs:
        bn = fused_ops.tile_n(n.cout)
        n_tiles = -(-n.cout // bn)
        last = n.cout - (n_tiles - 1) * bn   # columns of the last tile
        assert 0 < last <= bn and bn - last <= 15, (n.name, n.cout, bn)


@pytest.mark.parametrize("model,size,batch,limit", MODELS, ids=IDS)
def test_executed_over_useful_macs(model, size, batch, limit):
    """Executed: every 64-row tile over the batch, every column of every
    column tile, the depth in whole k32 steps."""
    convs, shapes = _convs(model, size)
    useful = executed = 0
    for n in convs:
        _, h, w = shapes[n.dst]
        m = batch * h * w
        depth = n.kernel ** 2 * n.cin
        bn = fused_ops.tile_n(n.cout)
        useful += m * n.cout * depth
        executed += (-(-m // ROWS) * ROWS) * (-(-n.cout // bn) * bn) \
            * (-(-depth // STEP) * STEP)
    assert useful > 0 and executed / useful <= limit, executed / useful


def test_tile_n_over_every_cout():
    """Any Cout the kernels take: as few column tiles as a 256-wide tile
    allows, each at most 15 columns wider than an even share of Cout."""
    for cout in range(1, fused_ops.MAX_COUT + 1):
        bn = fused_ops.tile_n(cout)
        n_tiles = -(-cout // fused_ops.MAX_TILE_N)
        assert bn % 16 == 0 and bn <= fused_ops.MAX_TILE_N
        assert -(-cout // bn) == n_tiles
        assert 0 <= bn - cout / n_tiles < 16


@pytest.mark.parametrize("cin,dtype,loader", [
    (3, torch.int8, "conv_gather"), (20, torch.int16, "conv_gather"),
    (48, torch.int8, "conv_vector"), (48, torch.int16, "conv_wide")])
def test_conv_loader_names_a_counter(cin, dtype, loader):
    x = torch.zeros((1, 2, 2, cin), dtype=dtype)
    assert fused_ops.conv_loader(x, cin) == loader
    assert loader in fused_ops.LAUNCHES


def test_cpu_entry_holds_no_tensor_map():
    """The TMA descriptor is made only for weights on a CUDA device; on
    the CPU the wrappers run the plain version and count nothing."""
    rng = np.random.default_rng(5)
    c = fused_ops.conv_entry(rng.integers(-127, 128, (24, 16, 3, 3)),
                             np.zeros(24), 1, 1, False, "cpu")
    assert c["w_map"] is None
    fused_ops.reset_counts()
    x = torch.as_tensor(rng.integers(-127, 128, (1, 5, 5, 16)),
                        dtype=torch.int8)
    out = fused_ops.conv3x3(x, c)
    assert torch.equal(out, fused_ops.conv_plain(x, c, None, 127))
    assert not any(fused_ops.LAUNCHES.values())
