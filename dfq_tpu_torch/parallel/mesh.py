"""Device meshes for data-parallel execution (port of
``dfq_tpu/parallel/mesh.py``).

The JAX package runs one controller over a ``Mesh`` of devices and lets
GSPMD insert the collectives. The port keeps that shape within a process:
a :class:`Mesh` is an explicit array of ``torch.device``s, a batch is split
over its data axis into one tensor per device (:class:`Sharded`), and the
parallel functions run each shard on its device and reduce on the host
side of the controller. Across processes, ``parallel/multihost.py`` adds
``torch.distributed``.

A device may repeat in a mesh. ``["cpu"] * 8`` is the port's counterpart
of the JAX tests' 8-device CPU mesh, and four shards on ``cuda:0``
exercise every split, per-shard launch and reduction on one card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from dfq_tpu_torch.device import resolve_device

DATA_AXIS = "data"

Device = Union[str, torch.device]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: an object array of ``torch.device`` with one dim per
    name of ``axis_names``."""

    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def distinct(self) -> List[torch.device]:
        """Each device of the mesh once, in mesh order."""
        return list(dict.fromkeys(self.devices.flat))


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so that equal devices compare equal."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices: Sequence[Device], shape: Tuple[int, ...],
              axis_names: Tuple[str, ...]) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (row-major). CUDA devices must
    exist: an entry point never falls back to the CPU."""
    devs = [_indexed(resolve_device(d)) for d in devices]
    for d in devs:
        if d.type == "cuda" and d.index >= torch.cuda.device_count():
            raise ValueError(f"{d} does not exist: {torch.cuda.device_count()} CUDA devices")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axis_names))


def cuda_devices(n_devices: Optional[int] = None) -> List[torch.device]:
    """The first ``n_devices`` CUDA devices (all by default); raises with
    the JAX package's message when fewer exist."""
    resolve_device(None)  # raises without CUDA
    count = torch.cuda.device_count()
    if n_devices is not None and n_devices > count:
        raise ValueError(
            f"requested a {n_devices}-device mesh but only {count} devices exist "
            "(check CUDA_VISIBLE_DEVICES)")
    return [torch.device("cuda", i) for i in range(count if n_devices is None else n_devices)]


def data_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[Device]] = None) -> Mesh:
    """A 1-D mesh over ``devices`` (which may repeat), by default every
    visible CUDA device (the first ``n_devices`` of them)."""
    if devices is None:
        devices = cuda_devices(n_devices)
    elif n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"requested a {n_devices}-device mesh but only "
                             f"{len(devices)} devices were given")
        devices = list(devices)[:n_devices]
    return make_mesh(devices, (len(devices),), (DATA_AXIS,))


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


@dataclasses.dataclass
class Sharded:
    """A batch split over a mesh's data axis: ``shards[i]`` (a tensor, or a
    tuple of tensors for a multi-output graph) lives on ``devices[i]``."""

    shards: List[Any]
    devices: List[torch.device]

    def gather(self, device: Optional[Device] = None):
        """The whole batch on ``device`` (the first shard's by default)."""
        dev = self.devices[0] if device is None else torch.device(device)
        first = self.shards[0]
        if isinstance(first, tuple):
            return tuple(torch.cat([s[i].to(dev) for s in self.shards])
                         for i in range(len(first)))
        return torch.cat([s.to(dev) for s in self.shards])


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def split_rows(x, n: int) -> List[torch.Tensor]:
    """``x``'s leading dim in ``n`` pieces as ``torch.tensor_split`` cuts it
    (the first ``len % n`` pieces one row longer); every piece non-empty."""
    x = _as_tensor(x)
    if x.shape[0] < n:
        raise ValueError(f"a batch of {x.shape[0]} cannot be split over {n} shards")
    return list(torch.tensor_split(x, n))


def to_device(x, device: torch.device) -> torch.Tensor:
    """A host array or a tensor on ``device`` without waiting for the copy:
    a host batch goes through pinned memory (from the caching host
    allocator, which keeps a block until its copy is done) with
    ``non_blocking=True`` on CUDA, so the copy of batch i+1 overlaps the
    forward of batch i."""
    t = _as_tensor(x)
    if device.type != "cuda":
        return t.to(device)
    if t.device.type == "cpu":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def shard_batch(mesh: Mesh, x) -> Sharded:
    """A host or device batch split along its leading dim over the data
    axis, each piece sent to its device by :func:`to_device`."""
    devices = list(mesh.devices.reshape(mesh.devices.shape[0], -1)[:, 0])
    return Sharded([to_device(p, d) for p, d in zip(split_rows(x, len(devices)), devices)],
                   devices)


def replicate(mesh: Mesh, tree) -> Dict[torch.device, Any]:
    """A copy of ``tree`` (nested dicts, lists and tuples of arrays or
    tensors) on each distinct device of the mesh: ``{device: tree}``."""
    return {d: _map(tree, lambda v, d=d: _as_tensor(v).to(d)) for d in mesh.distinct()}
