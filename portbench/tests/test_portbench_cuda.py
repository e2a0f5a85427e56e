"""On the card: each cell, and each served cell the benchmark does not
hold yet, runs through its whole path for a short window and comes out
correct. Run with ``python3 -m pytest portbench/tests -q -m cuda``."""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.tests.served import with_served

BENCH = with_served(json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text()))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = run.run_cell(BENCH, cell, 2**31 + 23, 2.0, False, "cuda", time.perf_counter())
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "gpu" and out["metrics"]
