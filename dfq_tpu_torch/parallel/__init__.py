"""Data-parallel, streaming, tensor-parallel and multi-process execution
(port of ``dfq_tpu/parallel``)."""

from dfq_tpu_torch.parallel.mesh import data_mesh, replicate, shard_batch  # noqa: F401
from dfq_tpu_torch.parallel.eval import (  # noqa: F401
    make_sharded_eval,
    make_sharded_forward,
    make_sharded_seg_eval,
)
from dfq_tpu_torch.parallel.calib import make_sharded_distill_step  # noqa: F401
from dfq_tpu_torch.parallel.stream import make_streaming_eval  # noqa: F401
from dfq_tpu_torch.parallel.tp import make_tp_int8_forward, tp_mesh  # noqa: F401
