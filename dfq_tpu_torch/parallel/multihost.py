"""Multi-process scale-out: process-group start, per-process data split
and global batches (port of ``dfq_tpu/parallel/multihost.py``).

The JAX package starts ``jax.distributed`` on every host, builds one
global mesh over all chips and lets GSPMD reduce across hosts. Here each
process drives the devices it sees (its local mesh, one controller as
within a process), and what crosses processes is reduced explicitly with
``torch.distributed.all_reduce``: :func:`all_reduce_sum` is what
``parallel/eval.py`` calls on its counters and confusion matrices. It is
a no-op while no process group is initialized, so one process behaves as
the JAX package's single-host case.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from dfq_tpu_torch.device import resolve_device
from dfq_tpu_torch.parallel.mesh import Device, Mesh, Sharded, data_mesh, shard_batch


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device: Optional[Device] = None,
) -> None:
    """Join the process group: ``nccl`` when this process's mesh is on CUDA
    (``device=None`` means CUDA), ``gloo`` on the CPU, rendezvous at
    ``tcp://<coordinator_address>`` (``host:port``; without one, at
    ``torch.distributed``'s ``env://`` variables). A no-op in a single
    process (``num_processes <= 1``) unless a coordinator is named, which
    forms a group of one."""
    single = num_processes is None or num_processes <= 1
    if single and coordinator_address is None:
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=init, world_size=num_processes or 1,
                            rank=process_id or 0)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def global_mesh(devices: Optional[Sequence[Device]] = None) -> Mesh:
    """The data mesh of this process's devices (every visible CUDA device
    by default); the job's global batch is every process's mesh in rank
    order."""
    return data_mesh(devices=devices)


def host_shard_bounds(total: int) -> tuple[int, int]:
    """[start, end) of this process's slice of a length-``total`` dataset:
    the per-process file-list split for input pipelines."""
    n, i = process_count(), process_index()
    per = (total + n - 1) // n
    return min(i * per, total), min((i + 1) * per, total)


@dataclasses.dataclass
class GlobalBatch(Sharded):
    """This process's rows of a batch that spans every process, sharded
    over its mesh; ``shape`` is the global one (``local * processes``)."""

    shape: tuple = ()

    def sum(self) -> torch.Tensor:
        """The sum over the whole global batch (every process's rows)."""
        local = sum(s.sum().to(self.devices[0]) for s in self.shards)
        return all_reduce_sum(local)


def make_global_batch(mesh: Mesh, local_batch) -> GlobalBatch:
    """This process's shard ``local_batch`` as part of a global batch whose
    leading dim is ``local * process_count()``."""
    sh = shard_batch(mesh, local_batch)
    shape = tuple(local_batch.shape)
    return GlobalBatch(sh.shards, sh.devices, (shape[0] * process_count(),) + shape[1:])


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over every process of the group (``t`` itself while no
    group is initialized). ``nccl`` reduces on the card and ``gloo`` on
    the CPU; the result comes back on ``t``'s device."""
    if not dist.is_initialized():
        return t
    if dist.get_backend() != "nccl":
        on = torch.device("cpu")
    else:
        on = t.device if t.is_cuda else torch.device("cuda", torch.cuda.current_device())
    buf = t.to(on).clone()
    dist.all_reduce(buf)
    return buf.to(t.device)
