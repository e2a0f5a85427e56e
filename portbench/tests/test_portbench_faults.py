"""A run with its timed path broken underneath comes out not correct: an
answer altered where it is produced (the forward's output, the NMS's
picks), and, served, a row returned to the wrong request. The harness's
look for a card is skipped; everything else of a run is driven, on the
CPU at a size a test holds."""

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import run
from portbench.tests.served import with_served

REPO = Path(__file__).resolve().parents[2]
BENCH = with_served(json.loads((REPO / "BENCHMARK.json").read_text()))
SMALL = {
    "mnv2_224.offline_b128": {"image_size": 48, "mix": {"batch": 2, "ring": 2, "check_rows": 2,
                                                         "check_steps": 2, "warmup_steps": 1}},
    "mnv2_224.served_poisson": {"image_size": 48, "mix": {
        "rate_per_s": 20.0, "pool": 4, "buckets": [1, 2], "check_rows": 2,
        "check_dispatches": 3}},
    "ssdlite_300.offline_b128": {"mix": {"batch": 1, "ring": 2, "check_rows": 1,
                                         "check_steps": 1, "warmup_steps": 1}},
    "resnet18_224.offline_b128": {"image_size": 48, "mix": {
        "batch": 2, "ring": 2, "check_rows": 2, "check_steps": 2, "warmup_steps": 1}},
}
torch.set_num_threads(2)


def _run(cell):
    return run.run_cell(BENCH, cell, 2**31 + 17, 1.0, False, "cpu", time.perf_counter(),
                        overrides=SMALL[cell])


def _alter_forward(monkeypatch):
    from dfq_tpu_torch.engine import int8_fused

    forward = int8_fused.Int8FusedNet.forward

    def altered(self, x, per_device_batch=None):
        """Each image's class scores moved one class along: every answer
        names the wrong class."""
        out = forward(self, x, per_device_batch)
        if isinstance(out, tuple):
            return (out[0].roll(1, dims=-1),) + out[1:]
        return out.roll(1, dims=-1)

    monkeypatch.setattr(int8_fused.Int8FusedNet, "forward", altered)


@pytest.mark.parametrize("cell", ["mnv2_224.offline_b128", "mnv2_224.served_poisson",
                                  "resnet18_224.offline_b128"])
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("cell", ["mnv2_224.offline_b128", "ssdlite_300.offline_b128",
                                  "resnet18_224.offline_b128"])
def test_altered_forward_output_fails(cell, monkeypatch):
    _alter_forward(monkeypatch)
    out = _run(cell)
    assert not out["correct"], out["check"]


def test_altered_nms_pick_fails(monkeypatch):
    from dfq_tpu_torch.detection import device_nms

    nms = device_nms.decode_nms_batch

    def altered(*a, **k):
        boxes, scores, valid = nms(*a, **k)
        return boxes, scores + valid.to(scores.dtype) * 1e-3, valid

    monkeypatch.setattr(device_nms, "decode_nms_batch", altered)
    out = _run("ssdlite_300.offline_b128")
    assert not out["correct"] and out["check"]["nms_diff"]["value"] > 0


def test_row_returned_to_the_wrong_request_fails(monkeypatch):
    from dfq_tpu_torch.serve import microbatch

    init = microbatch.MicroBatcher.__init__

    class Shifted:
        """numpy, with each result batch's rows rotated by one."""

        def __getattr__(self, name):
            return getattr(np, name)

        @staticmethod
        def asarray(a):
            return np.roll(np.asarray(a), 1, axis=0)

    def patched(self, *a, **k):
        init(self, *a, **k)
        self._np = Shifted()

    monkeypatch.setattr(microbatch.MicroBatcher, "__init__", patched)
    # dispatches of several distinct requests (a padding row repeats the
    # first request, whose own answer it then is)
    mix = SMALL["mnv2_224.served_poisson"]["mix"]
    monkeypatch.setitem(mix, "buckets", [4])
    monkeypatch.setitem(mix, "rate_per_s", 200.0)
    out = _run("mnv2_224.served_poisson")
    assert not out["correct"] and out["check"]["row_diff"]["value"] > 0
