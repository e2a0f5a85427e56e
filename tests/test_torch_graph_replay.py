"""The fused engine's CUDA-graph replay (``engine/int8_fused.py``), on the
CPU with the kernels' plain versions:

- the prefix a graph holds and the suffix run after its replay, in the
  four benchmark configurations' lowerings: the suffix is MobileNetV2's
  and ResNet-18's classifier, SSD-Lite's box concat and class softmax,
  DeepLab's final resize; an output that passes on or views a value takes
  that value's step into the suffix;
- the key: the input's shape, strides, dtype and device, and the policy;
- a key's first forward runs step by step, its second captures the
  prefix and replays it, later ones replay it (a capture hook that runs
  the prefix on the CPU stands in for the CUDA graph, and a stand-in
  stream and event for the caller's stream and the net's event): outputs
  equal to the step-by-step forward's, an earlier result untouched by a
  later call, the counters of forwards, each replay's wait on the event
  before its input copy and its record after its suffix, and under a
  profiler one ``int8_fused/graph`` range and the suffix's step ranges
  alone;
- a CPU net and a ``plain_kernels`` net run step by step and count only
  ``GRAPH_COUNTS["eager"]``.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dfq_tpu_torch import models
from dfq_tpu_torch.engine import Int8FusedNet, int8_fused, lower_int8
from dfq_tpu_torch.graph.ir import Graph
from dfq_tpu_torch.pipeline import QuantConfig, prepare

torch.set_num_threads(1)

# the four benchmark cells' configurations (builder, kwargs, QuantConfig
# flags), at sizes the CPU lowers quickly, and the suffix of each
CONFIGS = {
    "mobilenet_v2_224": ("mobilenet_v2", {}, {}, ["classifier"]),
    "resnet18_224": ("resnet18", {}, {}, ["fc"]),
    "ssdlite_mobilenet_v2_300": ("mobilenet_v2_ssd_lite", {"num_classes": 21},
                                 {"delete_single": True, "is_detection": True},
                                 ["loc_cat", "conf_softmax"]),
    "deeplab_mobilenet_v2_513": ("deeplab_mobilenet_v2", {"n_class": 21, "output_stride": 16,
                                                          "input_size": 65}, {}, ["final_up"]),
}
FLAGSHIP = dict(quantize=True, relu=True, equalize=True, absorption=True, correction=True,
                bits_bias=16)


def _net(builder, kwargs, flags, **options):
    g = getattr(models, builder)(**kwargs)
    prep = prepare(g, models.init_params(g, seed=0, bn_stats="random"),
                   QuantConfig(**FLAGSHIP, **flags))
    model = lower_int8(prep)
    residual = {k: v for k, v in prep.params.items() if k not in model.layers}
    return Int8FusedNet(model, device="cpu", params_f32=residual, **options)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_suffix_of_each_configuration(name):
    builder, kwargs, flags, suffix = CONFIGS[name]
    net = _net(builder, kwargs, flags)
    low = net.lowering(2)
    assert [n for n, _, _ in low.steps[low.cut:]] == suffix
    assert len(low.steps) - low.cut == len(suffix)
    graph = net.model.graph
    assert low.suffix_reads == frozenset(
        {i for n in suffix for i in graph[n].inputs} | set(graph.outputs))
    # no output is written before the cut
    assert not {n for n, _, _ in low.steps[:low.cut]} & set(graph.outputs)


def test_an_output_that_views_a_value_takes_its_step_into_the_suffix():
    """``fc -> dropout -> reshape`` as the output: the suffix starts at
    ``fc``, so the output is no view of the graph's memory."""
    net = _net("mobilenet_v2", {}, {})
    g = net.model.graph
    nodes = [n for n in g if n.name != "classifier"] + [
        g["classifier"],
        g["classifier"].replace(name="drop", op="dropout", inputs=("classifier",), attrs={}),
        g["classifier"].replace(name="flat", op="reshape", inputs=("drop",),
                                attrs={"shape": (1000,)}),
    ]
    net.model.graph = Graph(nodes, ("flat",))
    net.outputs = ("flat",)
    net._lowerings.clear()
    low = net.lowering(2)
    assert [n for n, _, _ in low.steps[low.cut:]] == ["classifier", "drop", "flat"]


def test_key_follows_shape_strides_dtype_and_policy():
    p0 = int8_fused.resolve_policy(2)
    p1 = int8_fused.resolve_policy(2, stem_s2d=True)
    x = torch.zeros(2, 8, 8, 3)
    key = int8_fused.graph_key(x, p0)
    assert key == int8_fused.graph_key(torch.ones(2, 8, 8, 3), p0)
    assert key == int8_fused.graph_key(torch.zeros(4, 8, 8, 3)[2:], p0)  # offset: same key
    others = [
        int8_fused.graph_key(torch.zeros(3, 8, 8, 3), p0),
        int8_fused.graph_key(torch.zeros(2, 3, 8, 8).permute(0, 2, 3, 1), p0),
        int8_fused.graph_key(torch.zeros(2, 8, 8, 3, dtype=torch.float64), p0),
        int8_fused.graph_key(x, p1),
    ]
    assert all(k != key for k in others)
    assert len(set(others)) == len(others)


@pytest.fixture(scope="module")
def mnv2():
    net = _net("mobilenet_v2", {}, {})
    rng = np.random.default_rng(7)
    xs = [torch.from_numpy(np.clip(rng.normal(0, 1, (2, 32, 32, 3)), -2.117, 2.64)
                           .astype(np.float32)) for _ in range(3)]
    with torch.no_grad():
        want = [net(x) for x in xs]
    return net, xs, want


def _counts():
    return dict(int8_fused.GRAPH_COUNTS)


def _moved(before):
    return {k: v - before[k] for k, v in int8_fused.GRAPH_COUNTS.items()}


class _Graphs:
    """Graph replay on the CPU: ``capture`` stands in for the net's
    ``_capture``; its graph's ``replay`` runs the prefix on the static
    input and leaves the boundary values where a CUDA graph's replay would
    write them. It is also the caller's stream and the net's event: it
    logs each wait on the event and each record of it, in order."""

    def __init__(self, net):
        self.net, self.keys, self.log = net, [], []

    def wait_event(self, event):
        assert event is self
        self.log.append("wait")

    def record(self, stream):
        assert stream is self
        self.log.append("record")

    def capture(self, low, x):
        net = self.net
        self.keys.append(int8_fused.graph_key(x, low.policy))
        cap = int8_fused.Captured(None, torch.empty_strided(x.shape, x.stride()), {},
                                  frozenset())

        def replay():  # as a graph's replay: no step opens a range
            done, env = set(), {net.input_name: cap.x}
            for name, _, step in low.steps[:low.cut]:
                if name not in done:
                    step(env, done, False)
            cap.env = {k: env[k] for k in low.suffix_reads if k in env}
            cap.done = frozenset(done)

        cap.graph = types.SimpleNamespace(replay=replay)
        return cap


def _graphed(net, monkeypatch):
    graphs = _Graphs(net)
    monkeypatch.setattr(net, "_graphable", lambda x, low: low.cut > 0)
    monkeypatch.setattr(net, "_capture", graphs.capture)
    monkeypatch.setattr(net, "_graphs", {})
    monkeypatch.setattr(net, "_seen", set())
    monkeypatch.setattr(net, "_suffix_done", graphs)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: graphs)
    return graphs


def test_second_sighting_captures_and_later_forwards_replay(mnv2, monkeypatch):
    net, xs, want = mnv2
    graphs = _graphed(net, monkeypatch)
    before = _counts()
    with torch.no_grad():
        first = net(xs[0])
        assert _moved(before) == {"captures": 0, "replays": 0, "eager": 1}
        assert graphs.keys == []
        second = net(xs[1])
        assert _moved(before) == {"captures": 1, "replays": 1, "eager": 1}
        third = net(xs[2])
        again = net(xs[0])
        assert _moved(before) == {"captures": 1, "replays": 3, "eager": 1}
        # another batch is another key: its first forward runs step by step
        other = net(torch.cat([xs[0], xs[1]]))
        assert _moved(before) == {"captures": 1, "replays": 3, "eager": 2}
        net(torch.cat([xs[2], xs[0]]))
    assert _moved(before) == {"captures": 2, "replays": 4, "eager": 2}
    assert graphs.keys == [int8_fused.graph_key(xs[0], net.lowering(2).policy),
                           int8_fused.graph_key(other.new_empty(4, 32, 32, 3),
                                                net.lowering(4).policy)]
    for got, w in zip((first, second, third, again), (want[0], want[1], want[2], want[0])):
        assert torch.equal(got, w)
    assert torch.equal(other, torch.cat([want[0], want[1]]))
    # each replay waits for the previous replay's suffix and marks its own
    assert graphs.log == ["wait", "record"] * 4


def test_replay_under_a_profiler_opens_one_graph_range(mnv2, monkeypatch):
    net, xs, want = mnv2
    _graphed(net, monkeypatch)
    with torch.no_grad():
        net(xs[0])
        net(xs[0])
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = net(xs[1])
    assert torch.equal(got, want[1])
    names = [e.name for e in prof.events() if e.name.startswith("int8_fused/")]
    steps = [n for n in names if ":" in n]
    low = net.lowering(2)
    assert names.count(int8_fused.GRAPH) == 1
    assert steps == [f"int8_fused/{k}:{n}" for n, k, _ in low.steps[low.cut:]]


@pytest.mark.parametrize("plain", [False, True], ids=["cpu", "plain_kernels"])
def test_cpu_and_plain_kernel_nets_stay_eager(mnv2, plain):
    net, xs, want = mnv2
    if plain:
        net = Int8FusedNet(net.model, device="cpu", plain_kernels=True)
        cuda_input = types.SimpleNamespace(device=torch.device("cuda"))
        assert not net._graphable(cuda_input, net.lowering(2))
    assert not net._graphable(xs[0], net.lowering(2))
    before = _counts()
    with torch.no_grad():
        got = [net(xs[0]) for _ in range(3)]
    assert _moved(before) == {"captures": 0, "replays": 0, "eager": 3}
    assert net._graphs == {}
    for g in got:
        assert torch.equal(g, want[0])
