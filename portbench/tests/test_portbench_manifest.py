"""BENCHMARK.json against the rules its checks hold it to (keys, names,
units, bounds), and every name in it resolved to the files under
portbench/ that the harness reads."""

import json
import re
import shutil
import time
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.tests.served import with_served

REPO = Path(__file__).resolve().parents[2]
PB = REPO / "portbench"
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_and_entry_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for section, keys in KEYS.items():
        for e in BENCH[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert keys <= set(e) <= keys | extra, (section, e["name"])


def test_names_units_and_lines():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[section]:
            assert NAME.match(e["name"]), e["name"]
            names.append((section in ("end_to_end", "per_layer"), e["name"]))
    for e in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    for e in BENCH["end_to_end"]:
        assert e["source"] in ("host_clock", "device_trace")
        assert 0 < e["bound"] <= 0.25
    for e in BENCH["per_layer"]:
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(e["layer"])
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    metric_names = [n for is_metric, n in names if is_metric]
    assert len(metric_names) == len(set(metric_names))
    assert len({n for m, n in names if not m}) == len([n for m, n in names if not m])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_each_layer_metric_moves_a_metric_its_cells_report():
    cells = [w["name"] for w in BENCH["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", e2e[m["moves"]]):
            assert cell in e2e[m["moves"]], (m["name"], cell)
    for cell in cells:
        w = next(x for x in BENCH["workloads"] if x["name"] == cell)
        assert any(m["name"] != "setup_s" for m in run.cell_metrics(BENCH, w, False))
        assert run.cell_metrics(BENCH, w, True)


@pytest.mark.parametrize("bench", [BENCH, with_served(BENCH)], ids=["benchmark", "with_served"])
def test_every_name_resolves_to_its_files(bench):
    for c in bench["configs"]:
        assert (REPO / c["file"]).is_file()
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = json.loads((REPO / c["file"]).read_text())
        assert (PB / "reference" / f"{c['name']}.py").is_file()
        assert (PB / "tasks" / f"{cfg['task']}.py").is_file()
        assert (PB / "reference" / f"{cfg['task']}.py").is_file()
    for w in bench["workloads"]:
        mix = json.loads((PB / "traffic" / f"{w['traffic']}.json").read_text())
        assert (PB / "traffic" / f"{mix['kind']}.py").is_file()
        for trace, kind in ((False, "end_to_end"), (True, "layer_metrics")):
            for m in run.cell_metrics(bench, w, trace):
                assert callable(run.reader(kind, m["name"])), m["name"]


def test_added_cell_and_metrics_are_found_by_name(tmp_path, monkeypatch):
    """A new cell, traffic mix and metrics are added as files and
    entries only: the harness finds and runs them without an edit."""
    root = tmp_path / "portbench"
    shutil.copytree(PB, root, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "traffic" / "closed_b2.json").write_text(json.dumps(
        {"kind": "closed_batch", "batch": 2, "ring": 2, "warmup_steps": 1, "check_steps": 1,
         "check_rows": 1, "trace_steps": 2}))
    (root / "end_to_end" / "steps_done.py").write_text("def read(r):\n    return r['steps']\n")
    (root / "layer_metrics" / "dummy_share.offline_b2.py").write_text(
        "def read(t):\n    return 50.0\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mnv2_224.offline_b2", "config": "mobilenet_v2_224",
                               "traffic": "closed_b2", "chips": 1, "why": "a test's cell"})
    bench["end_to_end"].append({"name": "steps_done", "unit": "steps", "better": "higher",
                                "bound": 0.01, "source": "host_clock",
                                "workloads": ["mnv2_224.offline_b2"]})
    bench["per_layer"].append({"name": "dummy_share.offline_b2", "unit": "%",
                               "better": "higher", "source": "host_clock", "layer": "device",
                               "moves": "steps_done", "workloads": ["mnv2_224.offline_b2"]})
    monkeypatch.setattr(run, "ROOT", root)
    cell = bench["workloads"][-1]
    assert [m["name"] for m in run.cell_metrics(bench, cell, True)] == ["dummy_share.offline_b2"]
    assert run.reader("layer_metrics", "dummy_share.offline_b2")({}) == 50.0
    torch.set_num_threads(2)
    out = run.run_cell(bench, "mnv2_224.offline_b2", 7, 0.5, False, "cpu", time.perf_counter(),
                       overrides={"image_size": 32})
    assert out["metrics"]["steps_done"]["value"] >= 1
    assert list(out)[-1] == "check" and out["correct"]


def test_a_run_without_a_card_prints_no_result():
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("this process sees a CUDA card")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1", "--seconds", "1"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
