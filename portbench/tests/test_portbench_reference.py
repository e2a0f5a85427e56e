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
                                             ("ssdlite_mobilenet_v2_300", 300, 1),
                                             ("resnet18_224", 64, 2)])
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


def _frozen_graph(name):
    import importlib

    return importlib.import_module(f"portbench.reference.{name}").graph(_cfg(name))


def _port_graph(name, **kw):
    from dfq_tpu_torch import models

    return getattr(models, name)(**kw)


@pytest.mark.parametrize("graph,port_graph,size,ops,port_ops", [
    (lambda: _frozen_graph("mobilenet_v2_224"), lambda: _port_graph("mobilenet_v2"), 224,
     601_548_544, 601_548_544),
    (lambda: _frozen_graph("resnet18_224"), lambda: _port_graph("resnet18"), 224,
     3_628_146_688, 3_628_146_688),
    # the port's own graph: the benchmark holds no frozen DeepLab yet
    (lambda: _port_graph("deeplab_mobilenet_v2", input_size=513),
     lambda: _port_graph("deeplab_mobilenet_v2", input_size=513), 513,
     54_135_867_008, 54_314_124_928),
], ids=["mobilenet_v2_224", "resnet18_224", "deeplab_mnv2_513"])
def test_operation_count(graph, port_graph, size, ops, port_ops):
    """2 per MAC over every conv and linear layer, with the map's side
    followed through pools, pads and resizes. Each layer's count equals
    the port's own count from shapes (``layer_costs``), except a conv on a
    global pool's 1x1 output, which ``layer_costs`` counts at the pool's
    input side (DeepLab's ``aspp.global_avg_pool.1``: 163,840 operations,
    not 178,421,760)."""
    from dfq_tpu_torch.utils.profiling import layer_costs

    g = graph()
    hw = costs.shapes(g, size)
    rows = layer_costs(port_graph(), 1, size)
    assert costs.model_ops_per_image(g, size) == ops
    assert sum(r["flops"] for r in rows) == port_ops
    want = {r["name"]: r["flops"] for r in rows}
    for name, macs in costs.layer_macs(g, size).items():
        src = g[g[name].inputs[0]]
        kept = hw[src.inputs[0]] if src.op == "global_pool" else 1
        assert 2 * macs * kept * kept == want[name], name


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


def _op_graph(builder, op):
    """A small graph around one parameter-free op, built with ``builder``
    (the port's or the frozen one), with the same node names either way:
    the max pool feeds a conv and a residual add as ResNet-18's does, the
    pad a depthwise conv without padding as DeepLab's backbone does, the
    resize (33 -> 129) a 1x1 conv head, and the global pool a 1x1 conv as
    ASPP's does."""
    b = builder()
    x = b.input("data")
    x = b.conv("c0", x, 3, 16, (3, 3), padding=(1, 1))
    x = b.bn("c0.bn", x, 16)
    x = b.relu("c0.relu", x)
    if op == "maxpool":
        x = b.maxpool("pool", x, window=(3, 3), stride=(2, 2), padding=(1, 1))
        y = b.conv("c1", x, 16, 16, (3, 3), padding=(1, 1))
        y = b.bn("c1.bn", y, 16)
        x = b.relu("c1.relu", b.add("add", x, y))
    elif op == "pad":
        x = b.pad("pad", x, pads=(1, 1, 1, 1))
        x = b.conv("c1", x, 16, 16, (3, 3), groups=16)
        x = b.relu("c1.relu", b.bn("c1.bn", x, 16))
        return b.build([b.conv("head", x, 16, 8, (1, 1), bias=True)])
    elif op == "interpolate":
        x = b.interpolate("up", x, size=(129, 129), align_corners=True)
        return b.build([b.conv("head", x, 16, 8, (1, 1), bias=True)])
    else:
        x = b.global_pool("pool", x)
        x = b.relu("c1.relu", b.bn("c1.bn", b.conv("c1", x, 16, 32, (1, 1)), 32))
        return b.build([b.conv("head", x, 32, 8, (1, 1), bias=True)])
    x = b.global_mean("mean", x)
    return b.build([b.linear("fc", x, 16, 10)])


@pytest.mark.parametrize("op,size", [("maxpool", 32), ("pad", 16), ("interpolate", 33),
                                     ("global_pool", 32)])
def test_parameter_free_op_agrees_with_the_port(op, size):
    """Same seeded floats into a small graph around ``op``: the frozen
    passes give the port's quantized model bit for bit, and the float64
    reference gives ``Int8FusedNet``'s outputs (CPU) within a row gap of
    0.03, a fifth of the classifiers' limit. Sound graphs read 3e-8 to 7e-8,
    and the resize 0.9e-2 to 1.6e-2 (its taps fall on quarters, so its
    outputs lie on exact ties of the grid, which float32 and float64
    break apart); a reference that pads with 0.5 reads 5e-2 or more, one
    that pools by the mean, flips ``align_corners`` or scales the global
    pool by 1.1 more again."""
    from dfq_tpu_torch.engine import Int8FusedNet, lower_int8
    from dfq_tpu_torch.graph.ir import GraphBuilder as PortBuilder
    from dfq_tpu_torch.pipeline import QuantConfig, prepare

    from portbench.reference.dfq.ir import GraphBuilder

    cfg = dict(_cfg("mobilenet_v2_224"), image_size=size)
    graph, port_graph = _op_graph(GraphBuilder, op), _op_graph(PortBuilder, op)
    gen = seeded.generator(2**31 + 3, "cpu")
    params = seeded.make_params(graph, gen)
    seeded.check_against(port_graph, params)
    x = seeded.make_images(2, cfg, gen)
    prep = prepare(port_graph, params, QuantConfig(quantize=True, **cfg["quant"]))
    rp = ref_prepare.prepare(graph, params, ref_prepare.QuantConfig(**cfg["quant"]))
    assert prep.act_ranges == rp.act_ranges
    assert {k: set(v) for k, v in prep.params_fp.items()} == {
        k: set(v) for k, v in rp.params_fp.items()}
    for layer, p in rp.params_fp.items():
        for k, v in p.items():
            assert np.array_equal(prep.params_fp[layer][k], v), (layer, k)
    model = lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model.layers}
    with torch.no_grad():
        got = Int8FusedNet(model, device="cpu", params_f32=residual)(x)
    want = int8_model.Reference(int8_model.lower(rp, 8), "cpu")(x)[0]
    assert got.shape == want.shape
    assert row_gap(got, want) <= 0.2 * cfg["limits"]["logit_gap"]
