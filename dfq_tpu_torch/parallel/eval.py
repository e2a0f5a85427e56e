"""Data-parallel sharded evaluation (port of ``dfq_tpu/parallel/eval.py``).

The batch is split over the mesh's data axis, each shard runs through a
replica of the engine on its device, and the per-shard top-1 counters (or
confusion matrices) are summed on the device of the first shard, then
across processes (``multihost.all_reduce_sum``), and fetched once. The
three engines shard the same way: the fake-quant simulator
(:func:`~dfq_tpu_torch.graph.execute`), the baseline int8 engine
(:class:`~dfq_tpu_torch.engine.Int8Net`) and the fused engine on the
hand-written kernels (:class:`~dfq_tpu_torch.engine.Int8FusedNet`). Every
per-image computation is the single-device one, so the sharded outputs
are bit-equal to a single forward on the same device type.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dfq_tpu_torch.graph.executor import execute, params_to
from dfq_tpu_torch.graph.ir import Graph
from dfq_tpu_torch.parallel.mesh import Mesh, Sharded, shard_batch, split_rows
from dfq_tpu_torch.parallel.multihost import all_reduce_sum


def on_device(device: torch.device):
    """The context a shard runs in: its CUDA device current (so that
    allocations and the kernels' streams are that device's)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _replica(graph, params, engine, device, act_ranges, bits_act, int8_model):
    if engine == "int8":
        from dfq_tpu_torch.engine import Int8Net

        return Int8Net(int8_model, params, device=device)
    if engine == "fused":
        from dfq_tpu_torch.engine import Int8FusedNet

        return Int8FusedNet(int8_model, device=device, params_f32=params)
    sim_params = params_to(params, device)
    return lambda x: execute(graph, sim_params, x, act_ranges=act_ranges or {},
                             bits_act=bits_act, device=device)


def make_sharded_forward(
    graph: Graph,
    params,
    mesh: Mesh,
    *,
    act_ranges: Optional[Dict[str, Tuple[float, float]]] = None,
    bits_act: int = 8,
    int8_model=None,
    engine: Optional[str] = None,
):
    """Returns ``fwd(x) -> Sharded`` logits, ``x`` (host or device; or a
    :class:`Sharded` batch already placed on the mesh) split over the data
    axis. ``engine`` selects the path: "sim" (fake-quant
    executor), "int8" (baseline true-int8), "fused" (int8-to-int8);
    default "int8" when an ``int8_model`` is supplied, else "sim". One
    replica is built per distinct device of the mesh."""
    if engine is None:
        engine = "int8" if int8_model is not None else "sim"
    if engine in ("int8", "fused") and int8_model is None:
        raise ValueError(f"engine={engine!r} requires int8_model")
    if engine not in ("sim", "int8", "fused"):
        raise ValueError(f"unknown engine {engine!r}")
    replicas = {}
    for d in mesh.distinct():
        with on_device(d):
            replicas[d] = _replica(graph, params, engine, d, act_ranges, bits_act, int8_model)

    def run(x) -> Sharded:
        xs = x if isinstance(x, Sharded) else shard_batch(mesh, x)
        # the fused engine resolves its batch-dependent policy (auto_config)
        # with the PER-DEVICE batch, as the JAX package does: global / shards
        kw = {}
        if engine == "fused":
            n = len(xs.shards)
            kw["per_device_batch"] = max(sum(s.shape[0] for s in xs.shards) // n, 1)
        outs = []
        with torch.no_grad():
            for shard, d in zip(xs.shards, xs.devices):
                with on_device(d):
                    outs.append(replicas[d](shard, **kw))
        return Sharded(outs, xs.devices)

    return run


def count_correct(logits: Sharded, labels) -> torch.Tensor:
    """``[correct, total]`` (int64, on the first shard's device) of the
    top-1 predictions against ``labels``, split as ``logits`` is, summed
    over the shards and across processes. Nothing is fetched to the host."""
    labs = labels.shards if isinstance(labels, Sharded) else split_rows(labels, len(logits.shards))
    counts = []
    for lg, lb in zip(logits.shards, labs):
        with on_device(lg.device):
            lb = lb.to(lg.device)
            # the total as a fill on the device: a host scalar copied in
            # would make the host wait for the device
            counts.append(torch.stack([(lg.argmax(-1) == lb).sum(),
                                       lb.new_full((), lb.shape[0], dtype=torch.int64)]))
    home = logits.devices[0]
    return all_reduce_sum(sum(c.to(home) for c in counts))


def make_sharded_eval(
    graph: Graph,
    params,
    mesh: Mesh,
    *,
    act_ranges: Optional[Dict[str, Tuple[float, float]]] = None,
    bits_act: int = 8,
    int8_model=None,
    engine: Optional[str] = None,
):
    """Returns ``step(x, labels) -> (n_correct, n_total)`` with ``x``
    sharded over the data axis. See :func:`make_sharded_forward` for
    engine selection."""
    fwd = make_sharded_forward(graph, params, mesh, act_ranges=act_ranges,
                               bits_act=bits_act, int8_model=int8_model, engine=engine)

    def run(x, labels):
        correct, total = count_correct(fwd(x), labels).tolist()
        return int(correct), int(total)

    return run


def confusion(pred: torch.Tensor, targets: torch.Tensor, num_class: int) -> torch.Tensor:
    """The ``num_class x num_class`` int64 confusion matrix (rows: truth)
    on ``pred``'s device: pixels whose truth is outside ``[0, num_class)``
    (the reference Evaluator's mask, ``utils/metrics.py:19``) land in an
    overflow bin that is dropped."""
    gt = targets.to(device=pred.device, dtype=torch.int64)
    valid = (gt >= 0) & (gt < num_class)
    label = torch.where(valid, num_class * gt + pred, num_class * num_class)
    counts = torch.bincount(label.reshape(-1), minlength=num_class * num_class + 1)
    return counts[:-1].reshape(num_class, num_class)


def make_sharded_seg_eval(
    graph: Graph,
    params,
    mesh: Mesh,
    num_class: int,
    *,
    act_ranges: Optional[Dict[str, Tuple[float, float]]] = None,
    bits_act: int = 8,
    int8_model=None,
    engine: Optional[str] = None,
):
    """Segmentation analog of :func:`make_sharded_eval`: returns
    ``step(x, targets) -> confusion[num_class, num_class]`` (numpy int64)
    with the batch sharded over the data axis and the metric computed on
    each shard's device (argmax, validity mask, bincount), so the one
    device-to-host copy a step is a C x C matrix instead of per-pixel
    logits. Accumulate the returned matrices in
    :class:`dfq_tpu_torch.metrics.SegEvaluator.confusion_matrix`."""
    fwd = make_sharded_forward(graph, params, mesh, act_ranges=act_ranges,
                               bits_act=bits_act, int8_model=int8_model, engine=engine)

    def run(x, targets) -> np.ndarray:
        out = fwd(x)
        mats = []
        for lg, gt in zip(out.shards, split_rows(targets, len(out.shards))):
            with on_device(lg.device):
                mats.append(confusion(lg.argmax(-1), gt, num_class))
        total = sum(m.to(out.devices[0]) for m in mats)
        return all_reduce_sum(total).cpu().numpy().astype(np.int64)

    return run
