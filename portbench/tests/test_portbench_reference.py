"""The plain reference against the port on the CPU, and the frozen counts of
operations and bytes."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import seeded
from portbench.reference import costs, int8_model
from portbench.reference.dfq import prepare as ref_prepare
from portbench.reference.classify import row_gap

PB = Path(__file__).resolve().parents[1]
torch.set_num_threads(2)


def _cfg(name):
    return json.loads((PB / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,size,batch", [("mobilenet_v2_224", 64, 2),
                                             ("ssdlite_mobilenet_v2_300", 300, 1)])
def test_reference_agrees_with_the_port(name, size, batch):
    """Same seeded floats into both: the frozen passes give the port's
    quantized model bit for bit, and the float64 forward its outputs
    within the configuration's limits (plain kernels, CPU)."""
    import importlib

    from dfq_tpu_torch.engine import Int8FusedNet, lower_int8
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    from portbench.program import load

    cfg = dict(_cfg(name), image_size=size)
    ref_mod = importlib.import_module(f"portbench.reference.{name}")
    gen = seeded.generator(2**31 + 99, "cpu")
    params = seeded.make_params(ref_mod.graph(cfg), gen)
    x = seeded.make_images(batch, cfg, gen)
    graph = load(cfg["program"]["graph"])(**cfg["program"]["graph_kwargs"])
    prep = prepare(graph, params, QuantConfig(quantize=True, **cfg["quant"]))
    rp = ref_prepare.prepare(ref_mod.graph(cfg), params, ref_prepare.QuantConfig(**cfg["quant"]))
    assert prep.act_ranges == rp.act_ranges
    for layer, p in rp.params_fp.items():
        for k, v in p.items():
            assert np.array_equal(prep.params_fp[layer][k], v), (layer, k)
    model = lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model.layers}
    with torch.no_grad():
        got = Int8FusedNet(model, device="cpu", params_f32=residual)(x)
    got = got if isinstance(got, tuple) else (got,)
    want = int8_model.Reference(int8_model.lower(rp, 8), "cpu")(x)
    names = {"classify": ["logit_gap"], "detect": ["conf_gap", "loc_gap"]}[cfg["task"]]
    for n, g, w in zip(names, got, want):
        assert row_gap(g, w) <= cfg["limits"][n], n


def test_mobilenet_v2_operation_count():
    """2 per MAC over every conv and linear layer of MobileNetV2 1.0 at
    224x224: 300.8 M MACs, against the port's own count from shapes."""
    from dfq_tpu_torch.models import mobilenet_v2
    from dfq_tpu_torch.utils.profiling import layer_costs

    from portbench.reference.mobilenet_v2_224 import graph

    ops = costs.model_ops_per_image(graph(_cfg("mobilenet_v2_224")), 224)
    assert ops == 601_548_544
    assert ops == sum(r["flops"] for r in layer_costs(mobilenet_v2(), 1, 224))


def test_kernel_site_bounds_at_b128():
    """The K1/K2/K3 sites of MobileNetV2's lowering at b128, each bounded by
    the larger of its operations and its bytes at the H100's peaks."""
    from portbench.reference.mobilenet_v2_224 import graph

    g = graph(_cfg("mobilenet_v2_224"))
    pk = costs.peaks("NVIDIA H100 80GB HBM3")
    expand, dw, proj, add = costs.block_layers(g, "features.3.conv.0")
    assert (dw, proj, add) == ("features.3.conv.3", "features.3.conv.6", "features.3.add")
    macs = costs.layer_macs(g, 224)
    k3 = costs.site_cost(g, 224, 128, "features.3.conv.0", "fused_block_int8")
    act = 128 * 56 * 56 * 24
    assert k3 == (2 * 128 * (macs[expand] + macs[dw] + macs[proj]),
                  2 * act + 144 * 24 + 9 * 144 + 24 * 144 + 8 * (2 * 144 + 24))
    k1 = costs.site_cost(g, 224, 128, "classifier", "matmul_int8_requant")
    assert k1 == (2 * 128 * 1280 * 1000, 128 * 1280 + 1000 * 1280 + 8 * 1000 + 128 * 1000 * 4)
    assert costs.site_bound_s(k1, pk) == k1[1] / 3.35e12
