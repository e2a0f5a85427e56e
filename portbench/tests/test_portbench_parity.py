"""The existing cells read what they read before the benchmark learned
pooling, padding and resizes: for MobileNetV2 224 and SSD-Lite 300, the
operations per image, every K1/K2/K3 site's operations and bytes at b128,
the seeded parameters and the reference's outputs for one seed, against
the values the benchmark gave at commit 704c356 (``parent_readings.json``)."""

import hashlib
import importlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import seeded
from portbench.reference import costs, int8_model
from portbench.reference.dfq.prepare import QuantConfig, prepare

PB = Path(__file__).resolve().parents[1]
PINNED = json.loads((Path(__file__).with_name("parent_readings.json")).read_text())
torch.set_num_threads(2)


def _sha256(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(PINNED["configs"]))
def test_existing_cells_read_as_before(name):
    pin = PINNED["configs"][name]
    cfg = json.loads((PB / "configs" / f"{name}.json").read_text())
    graph = importlib.import_module(f"portbench.reference.{name}").graph(cfg)
    size = cfg["image_size"]
    assert costs.model_ops_per_image(graph, size) == pin["ops_per_image"]
    sites = [[n, k, *map(int, costs.site_cost(graph, size, 128, n, k))]
             for n, k, _, _ in pin["sites_b128"]]
    assert sites == pin["sites_b128"]

    gen = seeded.generator(PINNED["seed"], "cpu")
    params = seeded.make_params(graph, gen)
    assert _sha256([params[n][k] for n in sorted(params)
                    for k in sorted(params[n])]) == pin["params_sha256"]
    x = seeded.make_images(pin["ref_batch"], dict(cfg, image_size=pin["ref_size"]), gen)
    ref = int8_model.Reference(int8_model.lower(prepare(graph, params, QuantConfig(
        **cfg["quant"])), 8), "cpu")(x)
    assert _sha256([r.numpy() for r in ref]) == pin["reference_sha256"]
