"""The generated work is a pure function of the seed."""

import numpy as np
import torch

from portbench import seeded
from portbench.reference.dfq.mobilenet_v2 import mobilenet_v2
from portbench.traffic.open_poisson import schedule


def test_open_loop_schedule_is_a_function_of_the_seed():
    a = schedule(800.0, 10.0, 256, 2**31 + 11)
    b = schedule(800.0, 10.0, 256, 2**31 + 11)
    c = schedule(800.0, 10.0, 256, 5)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])
    # every seed offers the same gaps, in another order
    ga, gc = np.sort(np.diff(a[0])), np.sort(np.diff(c[0]))
    n = min(len(ga), len(gc))
    assert abs(len(a[0]) - 8000) <= 2 and abs(len(c[0]) - 8000) <= 2
    assert np.allclose(ga[:n - 2], gc[:n - 2], rtol=0, atol=2e-3)
    assert a[1].min() >= 0 and a[1].max() < 256


def test_weights_and_images_are_a_function_of_the_seed():
    g = mobilenet_v2()
    cfg = {"image_size": 16, "input": {"mean": [127.0] * 3, "std": [128.0] * 3}}
    runs = []
    for seed in (2**32 + 3, 2**32 + 3, 4):
        gen = seeded.generator(seed, "cpu")
        runs.append((seeded.make_params(g, gen), seeded.make_images(3, cfg, gen)))
    (p1, x1), (p2, x2), (p3, x3) = runs
    assert all(np.array_equal(p1[n][k], p2[n][k]) for n in p1 for k in p1[n])
    assert torch.equal(x1, x2) and not torch.equal(x1, x3)
    assert not np.array_equal(p1["features.0.0"]["weight"], p3["features.0.0"]["weight"])
    # 8-bit pixels, normalised
    pix = x1 * 128.0 + 127.0
    assert torch.equal(pix, pix.round()) and pix.min() >= 0 and pix.max() <= 255


def test_seeded_parameters_are_checked_against_the_programs_graph():
    import pytest

    from dfq_tpu_torch.models import mobilenet_v2 as port_mobilenet_v2

    params = seeded.make_params(mobilenet_v2(), seeded.generator(1, "cpu"))
    seeded.check_against(port_mobilenet_v2(), params)
    bad = {k: dict(v) for k, v in params.items()}
    bad["classifier"]["weight"] = bad["classifier"]["weight"][:10]
    with pytest.raises(ValueError, match="other shapes"):
        seeded.check_against(port_mobilenet_v2(), bad)
    del bad["features.1.conv.0"]
    with pytest.raises(ValueError, match="missing"):
        seeded.check_against(port_mobilenet_v2(), bad)
