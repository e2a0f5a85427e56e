"""Tensor-parallel (channel-sharded) int8 execution over a 2-D mesh (port
of ``dfq_tpu/parallel/tp.py``).

Data parallelism keeps every weight on every device; for many models a
device, or a model whose weights exceed one device's memory, the
alternative is to shard the weights themselves. Each lowered layer's
int8 weight, ``wsum``, scale and bias are split on the output channel over
the mesh's ``model`` axis (conv ``qweight`` HWIO, linear ``[in, out]``,
the JAX package's layouts), the batch over its ``data`` axis. Where GSPMD
partitions the JAX engine and inserts the collectives, the port says it
by hand through the baseline engine's ``weights=`` override
(:class:`~dfq_tpu_torch.engine.Int8Net`): for each data shard, every
model shard computes its output-channel slice of each lowered layer from
the whole input (a grouped or depthwise conv from the input channels its
channels read), and the slices are gathered on the data shard's device
before the next node. The int8 products are exact and the epilogues per
channel, so the logits are bit-equal to the single-device engine's. The
baseline engine runs no hand-written kernel, so neither does this path.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dfq_tpu_torch.engine.int8 import Int8Model, Int8Net
from dfq_tpu_torch.parallel.eval import on_device
from dfq_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Device,
    Mesh,
    Sharded,
    cuda_devices,
    make_mesh,
    shard_batch,
)

MODEL_AXIS = "model"


def tp_mesh(n_data: int, n_model: int, devices: Optional[Sequence[Device]] = None) -> Mesh:
    """An ``n_data x n_model`` mesh over the first ``n_data * n_model`` of
    ``devices`` (which may repeat; every visible CUDA device by default)."""
    n = n_data * n_model
    devices = cuda_devices(n) if devices is None else list(devices)
    if len(devices) < n:
        raise ValueError(f"a {n_data}x{n_model} mesh needs {n} devices, got {len(devices)}")
    return make_mesh(devices[:n], (n_data, n_model), (DATA_AXIS, MODEL_AXIS))


def shard_int8_weights(model: Int8Model, mesh: Mesh, row: int = 0):
    """Every lowered layer's tensors with the output channel split over the
    model axis: ``{name: {"qweight", "wsum", "scale", "bias"}}``, each a
    list of shards, shard ``j`` on ``mesh.devices[row, j]``. Channel
    counts that the axis does not divide are split as
    ``torch.tensor_split`` splits them (the first shards one longer), as
    GSPMD allows."""
    devices = mesh.devices[row]
    n = len(devices)

    def split(a, axis):
        t = torch.as_tensor(np.ascontiguousarray(a))
        return [p.contiguous().to(d) for p, d in zip(torch.tensor_split(t, n, dim=axis), devices)]

    arrays = {}
    for name, L in model.layers.items():
        # conv OIHW -> HWIO, linear [out, in] -> [in, out]: O last
        qw = np.transpose(L.qweight, (2, 3, 1, 0)) if L.qweight.ndim == 4 else L.qweight.T
        arrays[name] = {
            "qweight": split(qw, -1),
            "wsum": split(np.asarray(L.wsum, np.int32), 0),
            "scale": split(np.asarray(L.w_scale, np.float32), 0),
            "bias": None if L.bias is None else split(np.asarray(L.bias, np.float32), 0),
        }
    return arrays


def make_tp_int8_forward(model: Int8Model, params_f32, mesh: Mesh):
    """Returns ``fwd(x) -> Sharded`` logits with the weights sharded over
    the model axis and the batch over the data axis: one baseline engine
    per data shard, on the first device of its mesh row, each lowered
    layer computed by the row's model shards."""
    nets = []
    for i, row in enumerate(mesh.devices):
        with on_device(row[0]):
            nets.append(Int8Net(model, params_f32, device=row[0],
                                weights=shard_int8_weights(model, mesh, row=i)))

    def run(x) -> Sharded:
        xs = shard_batch(mesh, x)
        outs = []
        with torch.no_grad():
            for net, shard, d in zip(nets, xs.shards, xs.devices):
                with on_device(d):
                    outs.append(net(shard))
        return Sharded(outs, xs.devices)

    return run
