"""Streaming host-fed evaluation: batches kept in flight (port of
``dfq_tpu/parallel/stream.py``).

The reference's eval loop is synchronous: a batch is produced, the GPU
consumes it, its accuracy is read, repeat (``main_cls.py:46-69``). Here
CUDA work is queued asynchronously, so the host keeps ``depth`` steps in
flight: each host batch is copied into pinned memory and sent to its
device with ``non_blocking=True`` (``mesh.shard_batch``: the copy of
batch i+1 overlaps the forward of batch i on the card), and each step's
counter stays on the device until ``depth`` batches later, when the host
reads it. Nothing in between waits for the card, provided the forward
itself never synchronises with the host (``chip_smoke.py`` reports the
host syncs of the fused forward and of a stream, as
``torch.cuda.set_sync_debug_mode("warn")`` finds them).
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Optional, Tuple

from dfq_tpu_torch.graph.ir import Graph
from dfq_tpu_torch.parallel.eval import count_correct, make_sharded_forward
from dfq_tpu_torch.parallel.mesh import Mesh, shard_batch


def stream_counters(step, batches: Iterable[Tuple], depth: int = 2) -> Tuple[int, int]:
    """Drive ``step(x, labels) -> device counter of correct predictions``
    over a host batch iterator keeping ``depth`` steps in flight; each
    counter becomes a Python int ``depth`` batches late, so the host's
    wait overlaps the device's work. Shared by :func:`make_streaming_eval`
    and ``run_cls --stream``."""
    correct = 0
    total = 0
    pending: deque = deque()
    for x, labels in batches:
        pending.append((step(x, labels), int(x.shape[0])))
        while len(pending) > depth:
            c0, n0 = pending.popleft()
            correct += int(c0)
            total += n0
    while pending:
        c0, n0 = pending.popleft()
        correct += int(c0)
        total += n0
    return correct, total


def make_streaming_eval(
    graph: Graph,
    params,
    mesh: Mesh,
    *,
    act_ranges=None,
    bits_act: int = 8,
    int8_model=None,
    engine: Optional[str] = None,
    depth: int = 2,
):
    """Returns ``run(batches) -> (n_correct, n_total)`` where ``batches``
    yields host ``(images NHWC f32, labels int)`` pairs. Keeps ``depth``
    device steps in flight; counters are read ``depth`` batches late."""
    fwd = make_sharded_forward(graph, params, mesh, act_ranges=act_ranges,
                               bits_act=bits_act, int8_model=int8_model, engine=engine)

    def step(x, labels):
        logits = fwd(x)  # sharded as shard_batch does
        return count_correct(logits, shard_batch(mesh, labels))[0]  # queued; nothing read yet

    def run(batches: Iterable[Tuple]) -> Tuple[int, int]:
        return stream_counters(step, batches, depth=depth)

    return run
