"""The control fails: the reference at int4, put in the program's place,
breaks a limit of each configuration (CPU, at a size a test holds)."""

import json
from pathlib import Path

import pytest
import torch

from portbench.control import control_numbers

PB = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


@pytest.mark.parametrize("name,size,rows", [("mobilenet_v2_224", 64, 4),
                                            ("ssdlite_mobilenet_v2_300", 300, 1),
                                            ("resnet18_224", 64, 4)])
def test_int4_control_fails_a_limit(name, size, rows):
    cfg = json.loads((PB / "configs" / f"{name}.json").read_text())
    cfg["image_size"] = size
    nums = control_numbers(cfg, 2**31 + 5, rows, "cpu")
    assert any(v > cfg["limits"][k] for k, v in nums.items()), nums
