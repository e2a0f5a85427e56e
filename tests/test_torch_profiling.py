"""``dfq_tpu_torch/utils`` against ``dfq_tpu/utils``: ``layer_costs`` field
for field (``bytes_padded`` included) on MobileNetV2, ResNet-18, SSD-Lite
and DeepLab-v3+ MobileNetV2 graphs; ``roofline_report`` within 1e-12
relative of JAX's when both get the same peaks and rates; the card peak
table; ``trace`` writing a trace on the CPU; ``visualize_per_layer``'s
boxes and medians."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import dfq_tpu.models as jm
import dfq_tpu.utils.profiling as jprof
import dfq_tpu_torch.models as tm
import dfq_tpu_torch.utils.profiling as tprof
from dfq_tpu_torch.utils import layer_costs, roofline_report, trace

torch.set_num_threads(1)

GRAPHS = {
    "mobilenet_v2": (lambda m: m.mobilenet_v2(), 224),
    "resnet18": (lambda m: m.resnet18(), 224),
    "ssd_lite": (lambda m: m.mobilenet_v2_ssd_lite(), 300),
    "deeplab": (lambda m: m.deeplab_mobilenet_v2(), 513),
}


@pytest.mark.parametrize("name", sorted(GRAPHS))
@pytest.mark.parametrize("act_bytes", [1, 4])
def test_layer_costs_equal_jax(name, act_bytes):
    build, size = GRAPHS[name]
    for batch in (1, 128):
        got = layer_costs(build(tm), batch, size, act_bytes=act_bytes)
        want = jprof.layer_costs(build(jm), batch, size, act_bytes=act_bytes)
        assert got == want
        assert len(got) > 10 and all(c["bytes_padded"] >= c["bytes"] for c in got)


def _close(a, b, path=""):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(b, str):
        assert a == b, path
    else:
        assert a == pytest.approx(b, rel=1e-12, abs=0), path


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_roofline_report_equals_jax(name):
    build, size = GRAPHS[name]
    _, peaks = tprof.card_peaks("NVIDIA H100 80GB HBM3")
    for rates in ({"dw_eff_bytes": 1.1e12, "mxu_int8_eff": 7.0e14}, tprof.calibrated_rates(peaks)):
        got = roofline_report(build(tm), 8, size, peaks=peaks, measured_time_s=0.0123,
                              measured_rates=rates)
        want = jprof.roofline_report(build(jm), 8, size, peaks=peaks, measured_time_s=0.0123,
                                     measured_rates=rates)
        _close(got, want)
    # the default rates are the peaks
    _close(roofline_report(build(tm), 8, size, peaks=peaks),
           jprof.roofline_report(build(jm), 8, size, peaks=peaks,
                                 measured_rates=tprof.calibrated_rates(peaks)))
    # a capped depthwise rate labels the layers it binds as JAX does
    capped = roofline_report(build(tm), 8, size, peaks=peaks,
                             measured_rates={"dw_eff_bytes": 1e9})
    assert capped["bound"] == "memory"


def test_card_peaks():
    assert tprof.card_peaks("NVIDIA H100 80GB HBM3")[0] == "H100"
    assert tprof.card_peaks("NVIDIA H100 PCIe")[0] == "H100 PCIe"
    assert tprof.card_peaks("NVIDIA H200")[0] == "H200"
    h100 = tprof.card_peaks("NVIDIA H100 80GB HBM3")[1]
    assert h100["hbm_bytes"] == 3.35e12 and h100["int8_ops"] == 1979e12
    with pytest.raises(RuntimeError, match="no peak table"):
        tprof.card_peaks("NVIDIA A100-SXM4-80GB")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            roofline_report(tm.mobilenet_v2(), 8)


def test_trace_writes_a_trace_on_the_cpu(tmp_path):
    logdir = tmp_path / "prof"
    with trace(str(logdir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(open(files[0]).read())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_visualize_per_layer_equals_jax(tmp_path):
    pytest.importorskip("matplotlib")
    from dfq_tpu.utils.visualize import visualize_per_layer as j_vis
    from dfq_tpu_torch.utils.visualize import visualize_per_layer as t_vis

    w = np.random.default_rng(0).normal(0, 1, (40, 8, 3, 3)).astype(np.float32)
    figs = [j_vis(w, title="w"), t_vis(torch.from_numpy(w), title="w",
                                       save_path=str(tmp_path / "w.png"))]
    medians = []
    for fig in figs:
        ax = fig.axes[0]
        lines = [ln for ln in ax.lines if ln.get_color() != "black"]
        medians.append([float(ln.get_ydata()[0]) for ln in lines])
        assert len(ax.get_xticks()) == 40
    assert len(medians[1]) == 40 and medians[0] == medians[1]
    np.testing.assert_allclose(medians[1], np.median(w.reshape(40, -1), axis=1), rtol=1e-6)
    assert (tmp_path / "w.png").stat().st_size > 0
