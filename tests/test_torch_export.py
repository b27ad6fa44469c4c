"""The port's export (export/{artifacts, pickles, verilog}, the native
Verilog writer) and load-back (quantize/loadq) against the JAX package's,
at 64 px on the CPU.

Every file of the port's artifact tree is byte-equal to the tree JAX's
export_all writes from the same QuantizedModel and golden image, with the
native writer and with the Python writers; the one exception,
results/QUANT_WEIGHTS_{K}.pickle (a torch.save zip), is compared as loaded
tensors. Both loaders rebuild a model equal field by field to the built
one, from the port's tree and from JAX's, and JAX loads the port's tree:
tolerance 0 on every field but ConvPlan.w_scales, the float weights'
scale, which no tree stores and the loaders re-derive as acc_scale /
in_scale (rtol 1e-15, two float64 roundings; nothing reads it after the
build). The port's and JAX's loaders agree on every field exactly."""

import dataclasses
import filecmp
import os

import numpy as np
import pytest

import conftest  # noqa: F401

from alpha_yolo_quant_tpu.export import artifacts as jart
from alpha_yolo_quant_tpu.export import pickles as jpick
from alpha_yolo_quant_tpu.quantize import loadq as jloadq
from alpha_yolo_quant_tpu.runtime.golden import golden_forward as j_golden
from alpha_yolo_quant_torch import native
from alpha_yolo_quant_torch.config import QuantConfig
from alpha_yolo_quant_torch.export import artifacts as tart
from alpha_yolo_quant_torch.export import pickles as tpick
from alpha_yolo_quant_torch.export import verilog as tver
from alpha_yolo_quant_torch.models.params import init_params
from alpha_yolo_quant_torch.quantize import loadq as tloadq
from alpha_yolo_quant_torch.runtime.golden import golden_forward
from test_torch_model_build import assert_same, build_pair

SIZE = 64
PACKED = "QUANT_WEIGHTS_{k}.pickle"
NUL = lambda *a, **k: None  # noqa: E731


def _export(tmp, k=8, full=True, seed=5):
    """Export one model with both packages into tmp/{t,j}: (port model,
    JAX model, port dir, JAX dir, params, golden env)."""
    tmodel, jmodel = build_pair(k=k, full_quant=full, seed=seed,
                                calib_seed=seed + 1)
    params = init_params(tmodel.graph, seed=seed)
    x = np.random.default_rng(seed + 2).uniform(
        0, 1, (1, 3, SIZE, SIZE)).astype(np.float32)
    env, jenv = golden_forward(tmodel, x), j_golden(jmodel, x)
    assert_same(env, jenv, "golden env")
    t_dir, j_dir = str(tmp / "t"), str(tmp / "j")
    tart.export_all(tmodel, env, params, t_dir, warn=NUL)
    jart.export_all(jmodel, jenv, params, j_dir, warn=NUL)
    return tmodel, jmodel, t_dir, j_dir, params, env


def _files(root):
    out = []
    for d, _, names in os.walk(root):
        out += [os.path.relpath(os.path.join(d, n), root) for n in names]
    return sorted(out)


def assert_trees_equal(got_dir, want_dir, k):
    """Every file byte-equal, the packed state dict tensor-equal."""
    files = _files(want_dir)
    assert _files(got_dir) == files
    packed = os.path.join("results", PACKED.format(k=k))
    assert packed in files and len(files) > 300
    differ = [f for f in files if f != packed and not filecmp.cmp(
        os.path.join(got_dir, f), os.path.join(want_dir, f), shallow=False)]
    assert not differ, differ[:5]
    assert_same(tpick.load_packed_state_dict(os.path.join(got_dir, packed)),
                jpick.load_packed_state_dict(os.path.join(want_dir, packed)),
                "packed state dict")


def assert_loaded(loaded, built, path):
    """A loaded model against the built one (see the module docstring)."""
    for name, c in built.convs.items():
        np.testing.assert_allclose(loaded.convs[name].w_scales, c.w_scales,
                                   rtol=1e-15, atol=0,
                                   err_msg=f"{path} {name}")
    assert_same(dataclasses.replace(loaded, convs={
        n: dataclasses.replace(c, w_scales=built.convs[n].w_scales)
        for n, c in loaded.convs.items()}), built, path)


@pytest.fixture(scope="module", params=[True, False],
                ids=["full", "partial"])
def trees(request, tmp_path_factory):
    return _export(tmp_path_factory.mktemp("export"), full=request.param)


def test_native_writer_builds_here():
    """g++ is present in this image: the port builds its own copy of the
    emitter (the Python writers are the fallback elsewhere)."""
    assert native.fastwriter() is not None
    assert native._target().exists()


def test_export_tree_byte_equal_to_jax(trees):
    tmodel, _, t_dir, j_dir, _, _ = trees
    assert_trees_equal(t_dir, j_dir, tmodel.cfg.k)
    full = tmodel.cfg.full_quant
    wp = os.path.join(t_dir, "weights_pickle")
    assert os.path.exists(os.path.join(wp, "dfl_conv.pickle")) == full
    assert os.path.exists(os.path.join(wp, "dfl.pickle")) != full


@pytest.mark.parametrize("trees", [True], ids=["full"], indirect=True)
def test_python_writers_byte_equal_to_native(trees, tmp_path, monkeypatch):
    """The full-quant tree again with the Python writers (a machine
    without a toolchain): byte-equal to the native writer's, and so to
    JAX's. (3.2 M weight lines in Python: the slowest test of the file.)"""
    tmodel, _, t_dir, _, params, env = trees
    monkeypatch.setattr(tver, "_native", lambda: None)
    py_dir = str(tmp_path / "py")
    tart.export_all(tmodel, env, params, py_dir, warn=NUL)
    assert_trees_equal(py_dir, t_dir, tmodel.cfg.k)


def test_verilog_writers_byte_equal_on_edge_values(tmp_path, monkeypatch):
    """Both writers on values at and over the bit budget (K=4 weights,
    18-bit biases), negative zero-padding included; same warnings."""
    rng = np.random.default_rng(9)
    conv = rng.integers(-9, 10, (3, 2, 3, 3))
    bias = rng.integers(-300000, 300000, (1, 3, 1, 1))
    act = rng.integers(-20, 21, (1, 3, 4, 5))
    out = {}
    for mode in ("native", "python"):
        d = tmp_path / mode
        tart.make_dirs(str(d))
        if mode == "python":
            monkeypatch.setattr(tver, "_native", lambda: None)
        warns = []
        tver.save_txt_weight(conv, bias, "L", "Conv2D", 4, str(d),
                             warn=warns.append)
        tver.save_txt_activations(act, "A", str(d), "act_conv", 4,
                                  warn=warns.append)
        out[mode] = {f: (d / f).read_bytes() for f in _files(str(d))}
        assert warns, mode
    assert out["native"] == out["python"] and len(out["native"]) == 2


@pytest.mark.parametrize("loader", ["artifacts", "packed"])
def test_loaders_rebuild_the_built_model(trees, loader):
    """Port loader on the port's and on JAX's tree, JAX loader on the
    port's tree: equal to the built models, and the two packages'
    loaders equal to each other on every field."""
    tmodel, jmodel, t_dir, j_dir, _, _ = trees
    cfg = tmodel.cfg
    t_load = {"artifacts": tloadq.model_from_artifacts,
              "packed": tloadq.model_from_packed_state_dict}[loader]
    j_load = {"artifacts": jloadq.model_from_artifacts,
              "packed": jloadq.model_from_packed_state_dict}[loader]
    loaded = t_load(t_dir, cfg)
    assert_loaded(loaded, tmodel, f"{loader} port tree")
    assert_same(t_load(j_dir, cfg), loaded, f"{loader} JAX tree")
    j_loaded = j_load(t_dir, jmodel.cfg)
    assert_loaded(j_loaded, jmodel, f"JAX {loader}")
    assert_same(loaded, j_loaded, f"{loader} port vs JAX loader")
    if not cfg.full_quant:
        np.testing.assert_array_equal(
            tloadq.dfl_weights_from_artifacts(t_dir),
            jloadq.dfl_weights_from_artifacts(j_dir))


@pytest.mark.parametrize("k", [4, 6])
def test_k_sweep_export_and_reload(tmp_path, k):
    """K=4/6 trees: byte-equal to JAX's, K-bit widths in the weight
    files, both loaders equal to the built model."""
    tmodel, _, t_dir, j_dir, _, _ = _export(tmp_path, k=k, full=False,
                                            seed=11)
    assert int(np.abs(tmodel.convs["Conv_P1"].w_q).max()) <= tmodel.cfg.qmax
    assert_trees_equal(t_dir, j_dir, k)
    wdir = os.path.join(t_dir, "quant_weights_yolov8n")
    f = next(n for n in os.listdir(wdir) if n.startswith("Conv_P1_"))
    first = next(ln for ln in open(os.path.join(wdir, f))
                 if ln.startswith("weight[0]"))
    assert f"{k - 1}'b" in first
    for load in (tloadq.model_from_artifacts,
                 tloadq.model_from_packed_state_dict):
        assert_loaded(load(t_dir, tmodel.cfg), tmodel, load.__name__)


def test_gz_packed_state_dict_from_a_torchless_tree_loads(trees, tmp_path):
    """JAX without torch writes the packed state dict as a gz-pickle of
    numpy arrays; the port's loader reads it."""
    tmodel, jmodel, _, _, params, _ = trees
    path = str(tmp_path / "gz.pickle")
    jpick.dump_gz_pickle(jpick.packed_state_dict(jmodel, params), path)
    assert_same(tpick.load_packed_state_dict(path),
                tpick.packed_state_dict(tmodel, params), "gz packed")


@pytest.mark.parametrize("trees", [False], ids=["partial"], indirect=True)
def test_full_quant_load_guards_partial_tree(trees):
    """A partial tree under a full-quant config is refused, as in JAX."""
    tmodel, _, t_dir, _, _, _ = trees
    assert not tmodel.cfg.full_quant
    cfg_fq = QuantConfig(model="yolov8n", k=8, image_size=SIZE,
                         full_quant=True)
    with pytest.raises(FileNotFoundError, match="partial-quant"):
        tloadq.model_from_packed_state_dict(t_dir, cfg_fq)
