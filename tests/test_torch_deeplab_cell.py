"""The benchmark's DeepLab-v3+ MobileNetV2 configuration (os16, 21 classes)
against the port, on the CPU with the kernels' plain versions:

- the frozen graph under ``portbench/reference/`` holds the port's layers,
  parameter names and shapes at 513x513;
- at 129x129, batch 2, one seed, the frozen DFQ passes give the port's
  activation ranges and float parameters bit for bit;
- ``Int8FusedNet`` is within the configuration's ``logit_gap`` of the
  float64 reference, and its labels pass the judge's exact ``label_diff``;
- the judge reads logits moved one class along as over the limit and one
  relabelled pixel as one image that differs;
- the fused engine's record of its f32 fallback steps holds DeepLab's 6
  f32 pads, 3 resizes and image pool with the bytes an image of their f32
  outputs, and exactly the fallback steps of MobileNetV2's lowering (none)
  and SSD-Lite's;
- the int8 concat's one-gather table gives each branch's requantized codes.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from dfq_tpu_torch.engine import Int8FusedNet, int8_fused, lower_int8
from dfq_tpu_torch.models import deeplab_mobilenet_v2
from dfq_tpu_torch.pipeline import QuantConfig, prepare
from portbench import seeded
from portbench.reference import deeplab_mobilenet_v2_513 as frozen
from portbench.reference import costs, int8_model, segment
from portbench.reference.dfq import prepare as ref_prepare

torch.set_num_threads(1)

CFG = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs"
                  / "deeplab_mobilenet_v2_513.json").read_text())
SEED = 2**31 + 99
FALLBACK_OPS = {
    "pad": [f"backbone.features.{i}.pad" for i in (1, 2, 7, 11, 14, 17)],
    "global_pool": ["aspp.global_avg_pool.0"],
    "interpolate": ["aspp.pool_up", "decoder.up", "final_up"],
}


def _cfg(size):
    return dict(CFG, image_size=size)


def _port_graph(size):
    return deeplab_mobilenet_v2(**dict(CFG["program"]["graph_kwargs"], input_size=size))


@pytest.fixture(scope="module")
def at_129():
    """Seeded parameters and images, the port's prepared model and fused
    net, and the frozen passes' prepared model, at 129x129, batch 2."""
    cfg = _cfg(129)
    gen = seeded.generator(SEED, "cpu")
    params = seeded.make_params(frozen.graph(cfg), gen)
    x = seeded.make_images(2, cfg, gen)
    prep = prepare(_port_graph(129), params, QuantConfig(quantize=True, **cfg["quant"]))
    rp = ref_prepare.prepare(frozen.graph(cfg), params, ref_prepare.QuantConfig(**cfg["quant"]))
    model = lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model.layers}
    net = Int8FusedNet(model, device="cpu", params_f32=residual)
    return x, prep, rp, net


def test_frozen_graph_holds_the_ports_layers_at_513():
    cfg = _cfg(513)
    g, port = frozen.graph(cfg), _port_graph(513)
    assert [(n.name, n.op, tuple(n.inputs), n.attrs) for n in g] == \
        [(n.name, n.op, tuple(n.inputs), n.attrs) for n in port]
    seeded.check_against(port, seeded.make_params(g, seeded.generator(SEED, "cpu")))


def test_frozen_passes_give_the_ports_model(at_129):
    _, prep, rp, _ = at_129
    assert prep.act_ranges == rp.act_ranges
    assert prep.params_fp.keys() == rp.params_fp.keys()
    for layer, p in rp.params_fp.items():
        assert prep.params_fp[layer].keys() == p.keys(), layer
        for k, v in p.items():
            assert np.array_equal(prep.params_fp[layer][k], v), (layer, k)


def test_fused_net_passes_the_judge(at_129):
    x, _, rp, net = at_129
    with torch.no_grad():
        logits = net(x)
    assert logits.shape == (2, 129, 129, CFG["num_classes"])
    want = int8_model.Reference(int8_model.lower(rp, 8), "cpu")(x)
    kept = {"out": logits, "labels": logits.argmax(-1).to(torch.uint8)}
    nums = segment.judge(kept, want, frozen, CFG)
    assert nums["logit_gap"] <= CFG["limits"]["logit_gap"], nums
    assert nums["label_diff"] == 0


def test_judge_catches_moved_logits_and_a_relabelled_pixel(at_129):
    x, _, rp, net = at_129
    with torch.no_grad():
        logits = net(x)
    want = int8_model.Reference(int8_model.lower(rp, 8), "cpu")(x)
    moved = logits.roll(1, dims=-1)
    nums = segment.judge({"out": moved}, want, frozen, CFG)
    assert nums["logit_gap"] > CFG["limits"]["logit_gap"] and nums["label_diff"] == 0
    labels = logits.argmax(-1).to(torch.uint8)
    labels[1, 64, 64] = (labels[1, 64, 64] + 1) % CFG["num_classes"]
    nums = segment.judge({"out": logits, "labels": labels}, want, frozen, CFG)
    assert nums["label_diff"] == 1 and nums["logit_gap"] <= CFG["limits"]["logit_gap"]


def _recorded(net, x):
    int8_fused.FALLBACK_BYTES.clear()
    with torch.no_grad():
        net(x)
    return dict(int8_fused.FALLBACK_BYTES)


def _f32_bytes(graph, size):
    """Bytes an image of every node's output in f32, from the frozen shapes."""
    side = costs.shapes(graph, size)
    ch = {}
    for n in graph:
        ch[n.name] = (3 if n.op == "input" else n.attrs["out_ch"] if n.op == "conv" else
                      n.attrs["out_f"] if n.op == "linear" else
                      sum(ch[i] for i in n.inputs) if n.op == "concat" else ch[n.inputs[0]])
    return {n.name: side[n.name] ** 2 * ch[n.name] * 4 for n in graph}


def test_fallback_counter_counts_deeplabs_f32_steps(at_129):
    x, _, _, net = at_129
    fallback = [n for n, kind, _ in net.lowering(2).steps if kind == "fallback"]
    assert sorted(fallback) == sorted(n for names in FALLBACK_OPS.values() for n in names)
    nbytes = _f32_bytes(frozen.graph(_cfg(129)), 129)
    assert nbytes["final_up"] == 129 * 129 * 21 * 4
    want = {n: (op, nbytes[n]) for op, names in FALLBACK_OPS.items() for n in names}
    assert _recorded(net, x) == want
    assert _recorded(net, x[:1]) == want


@pytest.mark.parametrize("name,size", [("mobilenet_v2", 32), ("mobilenet_v2_ssd_lite", 300)])
def test_fallback_counter_counts_the_lowerings_fallback_steps(name, size):
    """MobileNetV2 has none; SSD-Lite's are its softmax and reshapes."""
    from dfq_tpu_torch import models

    graph = getattr(models, name)()
    params = seeded.make_params(graph, seeded.generator(SEED, "cpu"))
    prep = prepare(graph, params, QuantConfig(quantize=True, relu=True, equalize=True))
    model = lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model.layers}
    net = Int8FusedNet(model, device="cpu", params_f32=residual)
    x = torch.zeros(1, size, size, 3)
    fallback = {n: graph[n].op for n, kind, _ in net.lowering(1).steps if kind == "fallback"}
    recorded = _recorded(net, x)
    assert {n: op for n, (op, _) in recorded.items()} == fallback
    assert all(nbytes > 0 for _, nbytes in recorded.values())


@pytest.mark.parametrize("shapes,axis,sliced", [
    ([(2, 3, 3, 6), (2, 3, 3, 4)], -1, False),   # pairs of codes
    ([(2, 3, 3, 5), (2, 3, 3, 4)], -1, False),   # single codes (odd rows)
    ([(2, 5, 3), (2, 4, 3)], 1, False),          # SSD-Lite's axis, pairs
    ([(2, 3, 3, 8), (2, 3, 3, 4)], -1, True),    # a strided branch
])
def test_concat_table_gives_its_maps_codes(shapes, axis, sliced):
    """The one-gather concat gives each branch's map of its codes (a
    requantization, or none), as the maps and ``torch.cat`` give them."""
    from dfq_tpu_torch.ops.rounding import f32, requant_i8

    def fn(q):
        return requant_i8(q, -3, f32(0.8123456), 7)

    gen = torch.Generator().manual_seed(3)
    qs = [torch.randint(-128, 128, s, dtype=torch.int8, generator=gen) for s in shapes]
    if sliced:
        qs[0] = qs[0][..., ::2]
    for fns in ([fn, None], [None, fn], [fn, fn]):
        want = torch.cat([q if f is None else f(q) for q, f in zip(qs, fns)], dim=axis)
        assert torch.equal(int8_fused.ConcatTable(fns, "cpu")(qs, axis), want)
