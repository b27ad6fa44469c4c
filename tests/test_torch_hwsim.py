"""The port's SRAM simulators (hwsim.sram, hwsim.refmem) and the per-layer
heatmaps against the JAX package's: the same allocator decisions, the same
trace and report bytes, the same capacity answers and the same errors."""

import os

import pytest

import conftest  # noqa: F401

from alpha_yolo_quant_tpu.config import QuantConfig as JConfig
from alpha_yolo_quant_tpu.eval import plots as jplots
from alpha_yolo_quant_tpu.hwsim import refmem as jrefmem
from alpha_yolo_quant_tpu.hwsim import sram as jsram
from alpha_yolo_quant_tpu.models.graph import build_yolov8_graph as jbuild
from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.eval import plots as tplots
from alpha_yolo_quant_torch.hwsim import refmem as trefmem
from alpha_yolo_quant_torch.hwsim import sram as tsram
from alpha_yolo_quant_torch.models.graph import build_yolov8_graph


def _graphs(model, size):
    return (build_yolov8_graph(QuantConfig(model=model, image_size=size)),
            jbuild(JConfig(model=model, image_size=size)))


def _alloc_script(mod):
    """tests/test_hwsim.py's first-fit/free case plus a rename and a
    split: the returned starts, segments and peak."""
    sim = mod.SramSim(total_cells=8 * 100)          # 100 rows
    starts = [sim.alloc("a", 8 * 10), sim.alloc("b", 8 * 20)]
    sim.free("a")
    starts.append(sim.alloc("c", 8 * 10))           # the hole left by a
    starts.append(sim.alloc("d", 8 * 10, place=-1))  # tail of last gap
    sim.rename("b", "b2")
    sim.split_halves("b2", "b2.x1", "b2.x2")
    starts.append(sim.alloc("e", 7))                # rounds up to a row
    segs = [(s.name, s.start, s.rows) for s in sim.segments]
    return starts, segs, sim.peak_rows, sim.peak_cells


def test_sram_first_fit_free_rename_equal_jax():
    got = _alloc_script(tsram)
    assert got == _alloc_script(jsram)
    starts, segs, peak_rows, _ = got
    assert starts[2] == 0 and starts[3] == 90 and peak_rows == 41
    assert ("b2.x1", 10, 10) in segs and ("b2.x2", 20, 10) in segs
    with pytest.raises(tsram.SramError, match="b2 not resident"):
        tsram.SramSim(8).find("b2")


def test_sram_oom_raises_like_jax():
    msgs = []
    for mod in (tsram, jsram):
        sim = mod.SramSim(total_cells=8 * 10)
        sim.alloc("a", 8 * 9)
        with pytest.raises(mod.SramError) as exc:
            sim.alloc("b", 8 * 5)
        msgs.append((str(exc.value), sim.oom_events))
    assert msgs[0] == msgs[1] == ("no space for b (5 rows)",
                                  ["b: need 5 rows"])
    assert tsram.DEFAULT_CELLS == jsram.DEFAULT_CELLS == 2_867_200
    assert tsram.COLUMNS == jsram.COLUMNS == 8


@pytest.mark.parametrize("model,size", [("yolov8n", 64), ("yolov8s", 64),
                                        ("yolov8m", 64), ("yolov8n", 640)])
def test_simulate_files_and_state_equal_jax(model, size, tmp_path):
    tg, jg = _graphs(model, size)
    got, want = tsram.simulate(tg, size), jsram.simulate(jg, size)
    assert got.trace == want.trace and len(got.trace) > 60
    assert got.snapshots == want.snapshots
    assert (got.peak_cells, got.peak_rows) == (want.peak_cells,
                                                want.peak_rows)
    assert got.oom_events == want.oom_events == []
    for name in ("memory.txt", "final_memory.txt"):
        paths = [str(tmp_path / f"{side}_{name}") for side in "tj"]
        for sim, path in zip((got, want), paths):
            getattr(sim, "write_memory_txt" if name == "memory.txt"
                    else "write_final_memory")(path)
        with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
            assert f.read() == g.read(), name
    if (model, size) == ("yolov8n", 640):
        # the reference sized its buffer for exactly this plan
        assert got.peak_cells == tsram.DEFAULT_CELLS


@pytest.mark.parametrize("model", ["yolov8n", "yolov8s", "yolov8m"])
def test_min_buffer_cells_equal_jax(model):
    for size in (64, 640):
        tg, jg = _graphs(model, size)
        got = tsram.min_buffer_cells(tg, size)
        assert got == jsram.min_buffer_cells(jg, size), size
        assert got % tsram.COLUMNS == 0
    if model == "yolov8n":
        assert got == tsram.DEFAULT_CELLS
        return
    # yolov8s/m at 640 do not fit the reference buffer: both raise alike
    with pytest.raises(tsram.SramError) as got_exc:
        tsram.simulate(tg, 640)
    with pytest.raises(jsram.SramError) as want_exc:
        jsram.simulate(jg, 640)
    assert str(got_exc.value) == str(want_exc.value)
    assert str(got_exc.value).startswith("no space for Conv_P1 (")


@pytest.fixture(scope="module")
def stage8_n640():
    """Both packages' replay of the reference's stage-8 memory trace for
    yolov8n at 640, computed once (about 9 s a side on a CPU)."""
    tg, jg = _graphs("yolov8n", 640)
    return (trefmem.simulate_stage8_memory(tg, 640),
            jrefmem.simulate_stage8_memory(jg, 640))


def test_stage8_memory_txt_equals_jax(stage8_n640):
    got, want = stage8_n640
    assert got.memory_txt() == want.memory_txt()
    assert got.memory_txt().count("\n") > 50


def test_stage8_final_memory_txt_equals_jax(stage8_n640):
    got, want = stage8_n640
    text = got.final_memory_txt()
    assert text == want.final_memory_txt()
    assert text.splitlines()[-1].startswith("MAX_MEMORY: ")


def test_stage8_yolov8s_640_raises_like_jax():
    tg, jg = _graphs("yolov8s", 640)
    with pytest.raises(RuntimeError) as got:
        trefmem.simulate_stage8_memory(tg, 640)
    with pytest.raises(RuntimeError) as want:
        jrefmem.simulate_stage8_memory(jg, 640)
    assert str(got.value) == str(want.value) == "no space for 409600 rows"


def test_memory_heatmaps_names_equal_jax(tmp_path):
    """5 PNGs under memory/, named as JAX names them (pixels are not
    compared: matplotlib writes metadata)."""
    tg, jg = _graphs("yolov8n", 64)
    names = []
    for side, plots, sim in (("t", tplots, tsram.simulate(tg, 64)),
                             ("j", jplots, jsram.simulate(jg, 64))):
        out = str(tmp_path / side)
        assert plots.plot_memory_heatmaps(sim, out, limit=5) == 5
        names.append(sorted(os.listdir(os.path.join(out, "memory"))))
    assert names[0] == names[1] and len(names[0]) == 5
    assert all(n.endswith(".png") for n in names[0])
