"""``portbench/spans.py``: device time and idle by the program's ranges,
on synthetic event lists (nested ranges, a launch found through its
runtime call, an op outside any range, a hand-written kernel launched by
its step's own range, idle that partly overlaps the NMS range, a device
annotation that is no op); the ``nms_host_syncs.det`` reader with and
without the program's counters; and ``measure`` driven on the CPU at a
size a test holds."""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import run, spans
from portbench.spans import Event

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
US = 1e-6


def host(name, start, end, id, linked=0, thread=1):
    return Event(name, False, start, end, thread, id, linked)


def dev(name, start, end, linked=0, id=0, annotation=False):
    return Event(name, True, start, end, 7, id, linked, annotation)


EVENTS = [
    host("int8_fused/conv:stem", 0, 100, 1),
    host("int8_fused/requant", 5, 20, 2),
    host("aten::mul", 6, 10, 3),
    host("int8_fused/product", 20, 60, 4),
    host("aten::convolution", 25, 55, 5),
    host("aten::copy_", 62, 64, 6),
    host("cudaLaunchKernel", 63, 63.5, 1006, linked=6),
    host("int8_fused/epilogue", 65, 99, 7),
    host("aten::add", 70, 72, 8),
    host("int8_fused/k1:features.1", 100, 130, 9),
    host("aten::cat", 135, 136, 10),
    host("device_nms/decode_nms_batch", 145, 300, 11),
    host("aten::any", 150, 151, 12),
    host("aten::argmax", 250, 251, 13),
    dev("mul_kernel", 50, 60, linked=3),
    dev("conv_kernel", 60, 90, linked=5),
    dev("copy_kernel", 90, 95, id=1006),  # found through its runtime call
    dev("add_kernel", 95, 100, linked=8),
    dev("mm_mma_kernel", 110, 140, linked=9),  # K1, launched by its step range
    dev("cat_kernel", 150, 152, linked=10),  # outside any step
    dev("any_kernel", 160, 161, linked=12),
    dev("argmax_kernel", 260, 262, linked=13),
    dev("portbench.nms", 160, 262, annotation=True),
]


def test_glue_by_phase_kind_and_node():
    a = spans.attribute(EVENTS)
    assert a["glue_s"] == pytest.approx(52 * US)
    assert a["glue_by_phase_s"] == pytest.approx(
        {"requant": 10 * US, "product": 30 * US, "step": 5 * US, "epilogue": 5 * US,
         "outside": 2 * US})
    assert a["glue_unattributed_s"] == pytest.approx(2 * US)
    assert a["glue_by_kind_s"] == pytest.approx({"conv": 50 * US})
    assert a["glue_by_node_s"] == pytest.approx({"stem": 50 * US})
    assert a["program_nms_device_s"] == pytest.approx(3 * US)
    assert a["program_nms_calls"] == 1
    assert a["launches_found"] == {"linked": 7, "runtime": 1, "none": 0}


def test_idle_by_innermost_range_and_nms_overlap():
    a = spans.attribute(EVENTS)
    # busy [50, 100], [110, 140], [150, 152], [160, 161], [260, 262]; the
    # annotation is no op. Gap (140, 150) straddles the NMS range's start.
    assert a["idle_s"] == pytest.approx((10 + 10 + 8 + 99) * US)
    assert a["idle_by_span_s"] == pytest.approx(
        {"k1 step": 10 * US, "outside": 5 * US,
         "device_nms/decode_nms_batch": (5 + 8 + 99) * US})
    assert a["nms_idle_s"] == pytest.approx((5 + 8 + 99) * US)


def test_innermost_range_of_nested_ranges():
    r = spans._Ranges([e for e in EVENTS if spans._is_program(e.name)])
    names = {t: (r.spans[i].name if (i := r.at(t)) is not None else None)
             for t in (1, 7, 30, 61, 80, 99.5, 120, 140, 200, 400)}
    assert names == {1: "int8_fused/conv:stem", 7: "int8_fused/requant",
                     30: "int8_fused/product", 61: "int8_fused/conv:stem",
                     80: "int8_fused/epilogue", 99.5: "int8_fused/conv:stem",
                     120: "int8_fused/k1:features.1", 140: None,
                     200: "device_nms/decode_nms_batch", 400: None}
    assert r.step_of(r.at(30)).name == "int8_fused/conv:stem"
    assert r.nms_of(r.at(200)) and not r.nms_of(r.at(30))


def test_without_program_ranges_everything_is_outside():
    plain = [e for e in EVENTS if not spans._is_program(e.name)]
    a = spans.attribute(plain)
    assert a["glue_s"] == pytest.approx(a["glue_unattributed_s"])
    assert a["program_nms_calls"] == 0 and a["nms_idle_s"] == 0
    assert set(a["idle_by_span_s"]) == {"outside"}


def test_nms_host_syncs_reader(monkeypatch):
    from dfq_tpu_torch.detection import device_nms

    read = run.reader("layer_metrics", "nms_host_syncs.det")
    monkeypatch.setattr(device_nms, "COUNTS",
                        {"calls": 4, "host_syncs": 40, "early_stops": 0})
    assert read({}) == 10.0
    monkeypatch.setattr(device_nms, "COUNTS", {"calls": 0, "host_syncs": 0, "early_stops": 0})
    assert read({}) is None
    monkeypatch.delattr(device_nms, "COUNTS")  # a program without the counters
    assert read({}) is None


SMALL = {
    "mnv2_224.offline_b128": {"image_size": 48, "mix": {"batch": 2, "ring": 2, "check_rows": 2,
                                                         "check_steps": 2, "warmup_steps": 1}},
    "ssdlite_300.offline_b128": {"mix": {"batch": 1, "ring": 2, "check_rows": 1,
                                         "check_steps": 1, "warmup_steps": 1}},
}


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_measure_on_the_cpu(cell):
    torch.set_num_threads(2)
    s = run.Setup(BENCH, cell, 2**31 + 29, 0.0, False, "cpu", SMALL[cell])
    out = spans.measure(s, 2, 0.0)
    assert out["synced"]["host_dispatch_ms"] > 0
    assert out["synced_profiled"]["host_dispatch_ms"] > 0
    assert out["window_ms_per_step"] > 0 and out["traced_ms_per_step"] > 0
    r = out["readings"]
    if cell.startswith("ssdlite"):
        assert out["synced"]["nms_host_syncs"] == out["synced_profiled"]["nms_host_syncs"]
        assert 1 <= out["synced"]["nms_host_syncs"] <= 10
        assert out["attributed"]["program_nms_calls"] == 2
        assert r["nms_host_syncs"] == out["synced"]["nms_host_syncs"]
    else:
        assert "nms_host_syncs" not in out["synced"] and r["nms_idle_ms_per_batch"] is None
    # no device here: nothing on the device to attribute
    assert out["attributed"]["glue_s"] == 0 and out["attributed"]["idle_s"] == 0
    assert "device" not in out
    assert time.perf_counter() > 0
