"""The segmentation cell run once on the CPU at a size a test holds, through
``run.run_cell``: a sound run is correct, and a run whose timed path is
broken underneath (each image's logits moved one class along, one pixel
relabelled) is not. The harness's look for a card is skipped."""

import json
import time
from pathlib import Path

import pytest
import torch

from portbench import run

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELL = "deeplab_mnv2_513.offline_b32"
MIX = {"batch": 2, "ring": 2, "check_rows": 2, "check_steps": 2, "warmup_steps": 1,
       "warmup_keeps": 3}
torch.set_num_threads(2)


def _run(size=65):
    cfg = json.loads((REPO / "portbench" / "configs" / "deeplab_mobilenet_v2_513.json").read_text())
    program = dict(cfg["program"], graph_kwargs=dict(cfg["program"]["graph_kwargs"],
                                                     input_size=size))
    overrides = {"image_size": size, "program": program, "mix": MIX}
    return run.run_cell(BENCH, CELL, 2**31 + 23, 1.0, False, "cpu", time.perf_counter(),
                        overrides=overrides)


@pytest.mark.parametrize("size", [65, 129])
def test_sound_run_is_correct(size):
    out = _run(size)
    assert out["correct"], out["check"]
    assert set(out["check"]) == {"logit_gap", "label_diff"}
    assert out["check"]["label_diff"]["value"] == 0


def test_logits_moved_one_class_along_fail(monkeypatch):
    from dfq_tpu_torch.engine import int8_fused

    forward = int8_fused.Int8FusedNet.forward

    def altered(self, x, per_device_batch=None):
        return forward(self, x, per_device_batch).roll(1, dims=-1)

    monkeypatch.setattr(int8_fused.Int8FusedNet, "forward", altered)
    out = _run()
    assert not out["correct"] and out["check"]["logit_gap"]["value"] > 1.0, out["check"]


def test_relabelled_pixel_fails(monkeypatch):
    from portbench.tasks import segment

    step = segment.Task.step

    def altered(self, x, spans=None):
        logits, aux = step(self, x, spans)
        labels = aux["labels"].clone()
        labels[0, 0, 0] = (labels[0, 0, 0] + 1) % logits.shape[-1]
        return logits, {"labels": labels}

    monkeypatch.setattr(segment.Task, "step", altered)
    out = _run()
    assert not out["correct"] and out["check"]["label_diff"]["value"] >= 1, out["check"]
    assert out["check"]["logit_gap"]["value"] <= out["check"]["logit_gap"]["limit"]
