"""The port's spans and counters (``engine/int8_fused.py``,
``detection/device_nms.py``), on the CPU at MobileNetV2 32², batch 2:

- with no profiler running, a forward opens no range and its outputs are
  bit-equal to a forward with the range helper untouched, and to a traced
  forward;
- under a CPU ``torch.profiler``, recording this thread or every thread
  (as the benchmark's stretch does), each step that ran opens exactly one
  step range ``int8_fused/<kind>:<node>``; the ``k1``/``k2``/``k3`` steps are
  the lowering's kernel sites by node and count; every ``conv`` step holds
  a ``product`` and an ``epilogue`` range, every ``k1``/``k2`` step a
  ``requant`` range;
- ``decode_nms_batch`` counts one host sync per pick step's alive check,
  with every candidate alive to the last step and with the early stop
  after a known step; the forward counter advances one call a forward;
- the counters lose no update under threads.
"""

import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dfq_tpu_torch.detection import device_nms
from dfq_tpu_torch.engine import Int8FusedNet, lower_int8
from dfq_tpu_torch.engine import int8_fused
from dfq_tpu_torch.models import init_params, mobilenet_v2
from dfq_tpu_torch.pipeline import QuantConfig, prepare

torch.set_num_threads(1)

KERNEL_KIND = {"matmul_int8_requant": "k1", "dw3x3_int8_requant": "k2",
               "fused_block_int8": "k3"}


@pytest.fixture(scope="module")
def mnv2():
    g = mobilenet_v2()
    cfg = QuantConfig(quantize=True, relu=True, equalize=True, absorption=True,
                      correction=True, bits_bias=16)
    prep = prepare(g, init_params(g, seed=0, bn_stats="random"), cfg)
    net = Int8FusedNet(lower_int8(prep), device="cpu")
    rng = np.random.default_rng(3)
    x = torch.from_numpy(
        np.clip(rng.normal(0, 1, (2, 32, 32, 3)), -2.117, 2.64).astype(np.float32))
    return net, x


def _forward(net, x):
    with torch.no_grad():
        return net(x)


def test_untraced_forward_opens_no_range(mnv2, monkeypatch):
    net, x = mnv2
    want = _forward(net, x)
    opened = []

    class Counting:
        def __init__(self, name):
            opened.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(int8_fused, "_Range", Counting)
    got = _forward(net, x)
    assert opened == []
    assert torch.equal(got, want)
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _forward(net, x)
    assert torch.equal(traced, want)


def _ran_steps(net, batch):
    """Wrap the lowering's steps to record the nodes whose step runs."""
    low = net.lowering(batch)
    ran = []

    def wrap(name, step):
        def recorded(env, done, spans):
            ran.append(name)
            step(env, done, spans)
        return recorded

    original = list(low.steps)
    low.steps[:] = [(n, k, wrap(n, s)) for n, k, s in original]
    return low, ran, original


def _step_of(e):
    while e is not None and ":" not in e.name:
        e = e.cpu_parent
    return e


def _profile(mode):
    if mode == "all_threads":  # the benchmark's stretch records every thread
        cfg = torch.profiler._ExperimentalConfig(profile_all_threads=True)
        return profile(activities=[ProfilerActivity.CPU], experimental_config=cfg)
    return profile(activities=[ProfilerActivity.CPU])


@pytest.mark.parametrize("mode", ["this_thread", "all_threads"])
def test_each_step_that_ran_has_one_step_range(mnv2, mode):
    net, x = mnv2
    low, ran, original = _ran_steps(net, x.shape[0])
    try:
        with _profile(mode) as prof:
            _forward(net, x)
    finally:
        low.steps[:] = original
    kinds = {n: k for n, k, _ in original}
    assert set(kinds.values()) <= set(int8_fused.STEP_KINDS)
    events = [e for e in prof.events() if e.name.startswith("int8_fused/")]
    steps = [e for e in events if ":" in e.name]
    assert Counter(e.name for e in steps) == Counter(
        f"int8_fused/{kinds[n]}:{n}" for n in ran)
    assert len(ran) == len(set(ran))
    # the kernel steps are the lowering's kernel sites, by node and count
    for kernel, kind in KERNEL_KIND.items():
        sites = sorted(n for n, k, _ in net.kernel_sites if k == kernel)
        assert sites and sorted(n for n in ran if kinds[n] == kind) == sites, kind
    assert {kinds[n] for n in ran} >= {"k1", "k2", "k3", "conv", "mean", "passthrough"}
    # K2 takes the stride-2 depthwise convs: the stem is the one conv step
    assert [n for n in ran if kinds[n] == "conv"] == ["features.0.0"]
    # the phases, each inside the step that opened it
    phases = {}
    for e in events:
        if ":" not in e.name:
            step = _step_of(e.cpu_parent)
            assert step is not None, e.name
            phases.setdefault(step.name, set()).add(e.name)
    assert {p for ps in phases.values() for p in ps} == {
        int8_fused.PRODUCT, int8_fused.REQUANT, int8_fused.EPILOGUE}
    for e in steps:
        kind = e.name.split("/")[1].split(":")[0]
        if kind == "conv":
            assert {int8_fused.PRODUCT, int8_fused.EPILOGUE} <= phases[e.name], e.name
        if kind in ("k1", "k2"):
            assert int8_fused.REQUANT in phases[e.name], e.name
        if kind in ("k3", "passthrough", "mean"):
            assert e.name not in phases, e.name


def test_forward_counter_advances_one_call_a_forward(mnv2):
    net, x = mnv2
    calls, seconds = net.host.calls, net.host.seconds
    for _ in range(2):
        _forward(net, x)
    assert net.host.calls == calls + 2
    assert net.host.seconds > seconds


def _nms_case(n_alive: int, n_priors: int = 20):
    """One image, one class: ``n_priors`` disjoint boxes, ``n_alive`` of
    them scored above the threshold."""
    cx = (np.arange(n_priors) + 0.5) / n_priors
    priors = np.stack([cx, np.full(n_priors, 0.5), np.full(n_priors, 0.5 / n_priors),
                       np.full(n_priors, 0.5 / n_priors)], -1).astype(np.float32)
    score = np.zeros(n_priors, np.float32)
    score[:n_alive] = np.linspace(0.9, 0.5, n_alive)
    conf = np.stack([1 - score, score], -1)[None]
    loc = np.zeros((1, n_priors, 4), np.float32)
    return torch.from_numpy(conf), torch.from_numpy(loc), torch.from_numpy(priors)


@pytest.mark.parametrize("n_alive, syncs, early", [(20, 10, 0), (3, 4, 1), (0, 1, 1)],
                         ids=["all_alive", "stops_after_3", "none_alive"])
def test_nms_counts_one_sync_a_pick_step(n_alive, syncs, early):
    conf, loc, priors = _nms_case(n_alive)
    before = dict(device_nms.COUNTS)
    _, _, valid = device_nms.decode_nms_batch(conf, loc, priors, top_k=10)
    assert int(valid.sum()) == min(n_alive, 10)
    after = device_nms.COUNTS
    assert after["calls"] - before["calls"] == 1
    assert after["host_syncs"] - before["host_syncs"] == syncs
    assert after["early_stops"] - before["early_stops"] == early


def test_nms_range_only_under_a_profiler():
    conf, loc, priors = _nms_case(5)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = device_nms.decode_nms_batch(conf, loc, priors)
    names = [e.name for e in prof.events()]
    assert names.count(device_nms.SPAN) == 1
    ranges = [e for e in prof.events() if e.name == device_nms.SPAN]
    # a FUNCTION-scope range: no user annotation that would take the
    # device annotation from a caller's record_function
    assert not getattr(ranges[0], "is_user_annotation", False)
    plain = device_nms.decode_nms_batch(conf, loc, priors)
    assert all(torch.equal(a, b) for a, b in zip(traced, plain))


def test_counters_lose_no_update_under_threads():
    interval = sys.getswitchinterval()
    host = int8_fused.HostTime()
    before = device_nms.COUNTS["early_stops"]
    n_threads, n = 16, 2000

    def work():
        for _ in range(n):
            host.add(1e-6)
            device_nms._count("early_stops")

    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert host.calls == n_threads * n
    assert device_nms.COUNTS["early_stops"] - before == n_threads * n
