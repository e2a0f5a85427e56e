"""The port's deployment path against the JAX package's: the native
exporter (``dfq_tpu_torch.io.native_export``), the runtime binding
(``dfq_tpu_torch.engine.native``, ``libdfqrt`` built with g++ into
``build/native/``) and ``python -m dfq_tpu_torch.cli.convert``.

- the port's exporter writes the same bytes as ``dfq_tpu.io.native_export``
  for the same full-width MobileNetV2 (carried across by
  ``interop.int8_model_from_jax``), and the bytes of ``golden/model_native.*``
  both from ``golden/artifact`` and from the golden script's graph, seed
  and config through the port's own pipeline;
- ``NativeModel`` gives ``golden/logits.npy`` within 1e-4, and matches the
  port's ``Int8Net`` on the CPU: on the tiny graph of
  ``tests/test_native_runtime.py`` at 1e-5, on MobileNetV2 224x224 b2
  under that file's contract (mean |diff| < 2e-3, max < 5e-2, >90% of the
  elements within 5e-3, equal top-1);
- ``convert --device cpu --validate`` in-process;
- a failed build raises with the compiler's output.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from dfq_tpu.engine import lower_int8 as j_lower_int8
from dfq_tpu.io.native_export import save_native_artifact as j_save_native
from dfq_tpu.models import init_params as j_init_params
from dfq_tpu.models import mobilenet_v2 as j_mobilenet_v2
from dfq_tpu.pipeline import QuantConfig as JQuantConfig
from dfq_tpu.pipeline import prepare as j_prepare
from dfq_tpu_torch.cli import convert
from dfq_tpu_torch.engine import Int8Net, lower_int8
from dfq_tpu_torch.engine import native
from dfq_tpu_torch.engine.native import NativeModel, build_native
from dfq_tpu_torch.graph.ir import GraphBuilder
from dfq_tpu_torch.interop import graph_from_jax, int8_model_from_jax, params_from_jax
from dfq_tpu_torch.io import load_artifact
from dfq_tpu_torch.io.native_export import save_native_artifact
from dfq_tpu_torch.models import init_params, mobilenet_v2
from dfq_tpu_torch.pipeline import QuantConfig, prepare

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "golden")
# the ncnn regime of convert and of the golden script
CONVERT = dict(quantize=True, relu=True, equalize=True, signed=True, bits_bias=32)


def _same_files(prefix_a, prefix_b):
    for ext in (".dfqparam", ".dfqbin"):
        assert filecmp.cmp(prefix_a + ext, prefix_b + ext, shallow=False), ext


@pytest.fixture(scope="module")
def lib():
    return build_native()


def test_library_built_by_the_port(lib):
    assert os.path.dirname(lib) == str(native.BUILD_DIR)
    assert os.path.basename(lib) == native.library_path().name


def test_export_equals_jax_full_width_mobilenet_v2(tmp_path):
    g = j_mobilenet_v2()
    prep = j_prepare(g, j_init_params(g, seed=0, bn_stats="random"), JQuantConfig(**CONVERT))
    model = j_lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model.layers}
    j_save_native(str(tmp_path / "jax"), model, residual)
    save_native_artifact(str(tmp_path / "port"), int8_model_from_jax(model),
                         params_from_jax(residual))
    _same_files(str(tmp_path / "jax"), str(tmp_path / "port"))


def test_golden_artifact_reexport_is_byte_identical(tmp_path):
    model, residual = load_artifact(os.path.join(GOLDEN, "artifact"))
    save_native_artifact(str(tmp_path / "m"), model, residual)
    _same_files(str(tmp_path / "m"), os.path.join(GOLDEN, "model_native"))


def test_golden_pipeline_is_byte_identical(tmp_path):
    """The golden script's graph, seed 7 and config through the port's
    ``init_params``, ``prepare`` and ``lower_int8``."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "make_golden_artifact", os.path.join(REPO, "scripts", "make_golden_artifact.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    g = graph_from_jax(script.golden_graph())
    prep = prepare(g, init_params(g, seed=7, bn_stats="random"), QuantConfig(**CONVERT))
    model = lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model.layers}
    save_native_artifact(str(tmp_path / "m"), model, residual)
    _same_files(str(tmp_path / "m"), os.path.join(GOLDEN, "model_native"))


def test_native_golden_logits(lib):
    x = np.load(os.path.join(GOLDEN, "input.npy"))
    want = np.load(os.path.join(GOLDEN, "logits.npy"))
    got = NativeModel(os.path.join(GOLDEN, "model_native"), lib_path=lib).forward(x)[0]
    assert got.shape == want.shape == (4, 10)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_native_tiny_graph_matches_int8net(lib, tmp_path):
    b = GraphBuilder()
    x = b.input("data")
    x = b.conv("c", x, 4, 8, (3, 3), stride=(2, 2), padding=(1, 1))
    x = b.relu("r", x)
    g = b.build([x])
    prep = prepare(g, init_params(g, seed=1), QuantConfig(quantize=False))
    prep.act_ranges = {"c:in0": (-2.0, 2.0)}
    model = lower_int8(prep)
    save_native_artifact(str(tmp_path / "tiny"), model, {})
    xin = np.random.default_rng(2).normal(0, 1, (1, 8, 8, 4)).astype(np.float32)
    got = NativeModel(str(tmp_path / "tiny"), lib_path=lib).forward(xin)[0]
    with torch.no_grad():
        want = Int8Net(model, prep.params, device="cpu")(torch.from_numpy(xin)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_native_mobilenet_v2_matches_int8net(lib, tmp_path):
    g = mobilenet_v2()
    prep = prepare(g, init_params(g, seed=0, bn_stats="random"),
                   QuantConfig(quantize=True, relu=True, equalize=True, bits_bias=16))
    model = lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model.layers}
    save_native_artifact(str(tmp_path / "mnv2"), model, residual)
    x = np.clip(np.random.default_rng(0).normal(0, 1, (2, 224, 224, 3)),
                -2.117, 2.64).astype(np.float32)
    got = NativeModel(str(tmp_path / "mnv2"), lib_path=lib).forward(x)[0]
    with torch.no_grad():
        want = Int8Net(model, residual, device="cpu")(torch.from_numpy(x)).numpy()
    diff = np.abs(got - want)
    assert got.shape == want.shape == (2, 1000)
    assert diff.mean() < 2e-3 and diff.max() < 5e-2, (diff.mean(), diff.max())
    assert float(np.mean(diff < 5e-3)) > 0.9
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_convert_cli_validates_on_the_cpu(lib, tmp_path, capsys):
    out_prefix = str(tmp_path / "mnv2")
    out = convert.main(["--relu", "--equalize", "--validate", "--device", "cpu",
                        "--out", out_prefix])
    printed = capsys.readouterr().out
    assert "native-vs-cpu: top1 agreement 1.0" in printed
    assert out["top1_agreement"] == 1.0 and out["max_abs"] < 5e-2
    for ext in (".dfqparam", ".dfqbin"):
        assert os.path.exists(out_prefix + "_native" + ext)
    # the artifact directory reloads to the model convert exported
    model, residual = load_artifact(out_prefix)
    save_native_artifact(str(tmp_path / "again"), model, residual)
    _same_files(str(tmp_path / "again"), out_prefix + "_native")
    # the ncnn regime: signed symmetric weights
    assert all(l.qweight.min() >= -127 for l in out["model"].layers.values())


def test_toolchain_takes_openmp_where_the_compiler_has_it(monkeypatch):
    """As ``native/CMakeLists.txt``'s optional ``find_package(OpenMP)``."""
    native.toolchain.cache_clear()
    try:
        monkeypatch.setattr(native, "_takes_openmp", lambda cxx: False)
        cxx, flags = native.toolchain()
        assert flags == native.CXX_FLAGS and not native.openmp()
        native.toolchain.cache_clear()
        monkeypatch.setattr(native, "_takes_openmp", lambda c: c == cxx)
        assert native.toolchain() == (cxx, native.CXX_FLAGS + ("-fopenmp",))
        assert native.openmp()
        # a $CXX without OpenMP is passed over for one that has it
        native.toolchain.cache_clear()
        monkeypatch.setenv("CXX", "/bin/true")
        monkeypatch.setattr(native, "_takes_openmp", lambda c: c != "/bin/true")
        assert native.toolchain()[0] != "/bin/true" and native.openmp()
    finally:
        native.toolchain.cache_clear()


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "dfqrt.h").write_text("")
    (src / "dfqrt.cpp").write_text("int broken( {\n")
    monkeypatch.setattr(native, "NATIVE_SRC", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building libdfqrt failed") as e:
        build_native()
    assert "dfqrt.cpp" in str(e.value)
    assert not list((tmp_path / "build").glob("*.so"))
